"""Frozen image encoder: ViT-class, Swinv2-base output contract
(counterpart of mmd_tpu/models/vit.py; the HF loaders arrive later).

A plain ViT with 32-px patches on 256-px inputs yields the Swinv2-base
contract of 8x8 = 64 tokens of width 1024 in one stage (reference
preprocess_embeddings.py:26-28,83-88; train.py:332).

The patch embedding is patchify + one linear, exactly as in the JAX
package, with the (c, py, px) flatten order. It is deliberately not a
Conv2d: cuDNN runs fp32 convolutions in TF32 by default.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.transformer import (
    TransformerConfig, encoder_layer, init_layer,
)


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 256
    patch_size: int = 32            # 256/32 = 8 -> 64 tokens
    hidden_size: int = 1024         # Swinv2-base final hidden
    num_layers: int = 12
    num_heads: int = 16
    intermediate_size: int = 4096
    dropout: float = 0.0
    layer_norm_eps: float = 1e-6
    fused_attn: bool = True
    compute_dtype: str = "bfloat16"
    pre_ln: bool = True            # standard ViT block order
    embed_ln: bool = True          # LN right after patch embed (HF ViT has
                                   # none — its conversion turns it off)
    use_cls: bool = False          # carry a CLS token through the blocks
                                   # (dropped from the output)
    keep_cls: bool = False         # keep CLS in the OUTPUT sequence
    remat: bool = False            # recompute blocks in the backward
                                   # (torch.utils.checkpoint); no effect
                                   # without gradients

    @property
    def num_tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def block_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.hidden_size, num_heads=self.num_heads,
            intermediate_size=self.intermediate_size, dropout=self.dropout,
            layer_norm_eps=self.layer_norm_eps, fused_attn=self.fused_attn,
            compute_dtype=self.compute_dtype, pre_ln=self.pre_ln,
        )


VIT_TEST = ViTConfig(image_size=32, patch_size=8, hidden_size=32,
                     num_layers=2, num_heads=4, intermediate_size=64,
                     compute_dtype="float32")


def init_vit(gen: torch.Generator, cfg: ViTConfig) -> L.ParamTree:
    block = cfg.block_cfg()
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    n_pos = cfg.num_tokens + (1 if cfg.use_cls else 0)
    p = {
        "patch_embed": L.linear_init(gen, patch_dim, cfg.hidden_size),
        "pos_embed": L.normal(gen, (n_pos, cfg.hidden_size), 0.02),
        "ln_pre": L.layernorm_init(cfg.hidden_size),
        "ln_post": L.layernorm_init(cfg.hidden_size),
        "layers": nn.ModuleList(init_layer(gen, block)
                                for _ in range(cfg.num_layers)),
    }
    if cfg.use_cls:
        p["cls_token"] = torch.zeros(cfg.hidden_size)
    return L.ParamTree(p)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, (H/p)*(W/p), 3*p*p), NHWC in, each patch
    flattened in (c, py, px) order."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 5, 2, 4)            # b, gh, gw, c, p, p
    return x.reshape(b, (h // patch) * (w // patch), c * patch * patch)


def vit_forward(params: L.ParamTree, cfg: ViTConfig, images: torch.Tensor
                ) -> torch.Tensor:
    """(B, H, W, 3) float -> last_hidden_state (B, num_tokens, hidden)."""
    dtype = L.dtype_of(cfg.compute_dtype)
    block = cfg.block_cfg()
    x = patchify(images.to(dtype), cfg.patch_size)
    x = L.linear(params["patch_embed"], x, dtype)
    if cfg.use_cls:
        cls = params["cls_token"].to(dtype).expand(x.shape[0], 1,
                                                    cfg.hidden_size)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dtype)[None]
    if cfg.embed_ln:
        x = L.layernorm(params["ln_pre"], x, cfg.layer_norm_eps)
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(p, x):
        return encoder_layer(p, block, x)[0]

    for p in params["layers"]:
        x = (checkpoint(layer, p, x, use_reentrant=False) if remat
             else layer(p, x))
    x = L.layernorm(params["ln_post"], x, cfg.layer_norm_eps)
    return x[:, 1:] if (cfg.use_cls and not cfg.keep_cls) else x
