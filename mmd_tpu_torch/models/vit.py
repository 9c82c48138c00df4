"""Frozen image encoder: ViT-class, Swinv2-base output contract
(counterpart of mmd_tpu/models/vit.py, with its HF ViT and BLIP vision
loaders).

A plain ViT with 32-px patches on 256-px inputs yields the Swinv2-base
contract of 8x8 = 64 tokens of width 1024 in one stage (reference
preprocess_embeddings.py:26-28,83-88; train.py:332).

The patch embedding is patchify + one linear, exactly as in the JAX
package, with the (c, py, px) flatten order. It is deliberately not a
Conv2d: cuDNN runs fp32 convolutions in TF32 by default.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import torch
from torch import nn

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

    def layer(p, x):
        return encoder_layer(p, block, x)[0]

    x = L.run_layers(layer, params["layers"], x, remat=cfg.remat)
    x = L.layernorm(params["ln_post"], x, cfg.layer_norm_eps)
    return x[:, 1:] if (cfg.use_cls and not cfg.keep_cls) else x


# -- HF conversion -------------------------------------------------------------

def config_from_hf(config_json: Mapping) -> ViTConfig:
    """The ViTConfig of a HF ViT `config.json` (a dict): pre-LN blocks, a
    CLS token carried through them and dropped from the output, no
    post-embedding LayerNorm (tools/convert_hf.py's settings)."""
    c = config_json
    if c.get("hidden_act", "gelu") != "gelu" or c.get("num_channels", 3) != 3:
        raise ValueError("the encoder computes a 3-channel GELU ViT only")
    return ViTConfig(
        image_size=c["image_size"], patch_size=c["patch_size"],
        hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        layer_norm_eps=c["layer_norm_eps"], pre_ln=True, embed_ln=False,
        use_cls=True)


def load_hf_vit_state_dict(state_dict: Mapping, cfg: ViTConfig
                           ) -> L.ParamTree:
    """A HF ViTModel state dict (torch or numpy values, no task prefix) as
    the port's encoder params. The config needs use_cls=True and
    embed_ln=False (HF ViT has no post-embedding LayerNorm; ln_pre stays
    at identity). The patch Conv2d (h, 3, p, p) becomes the patchify
    linear, whose rows flatten in (c, py, px) order."""
    if cfg.embed_ln or not cfg.use_cls:
        raise ValueError("HF ViT converts with use_cls=True, embed_ln=False")
    get = functools.partial(L.hf_tensor, state_dict)
    conv = get("embeddings.patch_embeddings.projection.weight")
    h = conv.shape[0]
    tensors = {
        "patch_embed.weight": conv.reshape(h, -1),
        "patch_embed.bias": get("embeddings.patch_embeddings.projection.bias"),
        "pos_embed": get("embeddings.position_embeddings")[0],
        "cls_token": get("embeddings.cls_token")[0, 0],
        "ln_pre.weight": torch.ones(h), "ln_pre.bias": torch.zeros(h),
        **L.hf_modules(state_dict, {"ln_post": "layernorm"})}
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}"
        tensors.update(L.hf_modules(state_dict, {
            f"layers.{i}.q": f"{pre}.attention.attention.query",
            f"layers.{i}.k": f"{pre}.attention.attention.key",
            f"layers.{i}.v": f"{pre}.attention.attention.value",
            f"layers.{i}.attn_out": f"{pre}.attention.output.dense",
            f"layers.{i}.ln1": f"{pre}.layernorm_before",
            f"layers.{i}.ffn_in": f"{pre}.intermediate.dense",
            f"layers.{i}.ffn_out": f"{pre}.output.dense",
            f"layers.{i}.ln2": f"{pre}.layernorm_after"}))
    params = init_vit(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, tensors, "vit")


def load_hf_blip_vision_state_dict(state_dict: Mapping, cfg: ViTConfig
                                   ) -> L.ParamTree:
    """A HF BlipVisionModel state dict (keys relative to `vision_model.`,
    torch or numpy values) as the port's encoder params. BLIP's vision
    tower is a pre-LN ViT with one qkv projection, no post-embedding
    LayerNorm, and a decoder that reads the whole sequence, CLS included:
    the config needs pre_ln, use_cls and keep_cls, and embed_ln=False
    (ln_pre stays at identity). The qkv rows split into q, k and v."""
    if cfg.embed_ln or not (cfg.use_cls and cfg.keep_cls and cfg.pre_ln):
        raise ValueError("BLIP vision converts with pre_ln, use_cls, "
                         "keep_cls and embed_ln=False")
    get = functools.partial(L.hf_tensor, state_dict)
    conv = get("embeddings.patch_embedding.weight")
    h = conv.shape[0]
    tensors = {
        "patch_embed.weight": conv.reshape(h, -1),
        "patch_embed.bias": get("embeddings.patch_embedding.bias"),
        "pos_embed": get("embeddings.position_embedding")[0],
        "cls_token": get("embeddings.class_embedding")[0, 0],
        "ln_pre.weight": torch.ones(h), "ln_pre.bias": torch.zeros(h),
        **L.hf_modules(state_dict, {"ln_post": "post_layernorm"})}
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        for leaf in ("weight", "bias"):
            qkv = get(f"{pre}.self_attn.qkv.{leaf}").chunk(3, dim=0)
            for name, part in zip(("q", "k", "v"), qkv):
                tensors[f"layers.{i}.{name}.{leaf}"] = part
        tensors.update(L.hf_modules(state_dict, {
            f"layers.{i}.attn_out": f"{pre}.self_attn.projection",
            f"layers.{i}.ln1": f"{pre}.layer_norm1",
            f"layers.{i}.ffn_in": f"{pre}.mlp.fc1",
            f"layers.{i}.ffn_out": f"{pre}.mlp.fc2",
            f"layers.{i}.ln2": f"{pre}.layer_norm2"}))
    params = init_vit(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, tensors, "vit")
