"""Transformer encoder stack (counterpart of mmd_tpu/models/transformer.py).

BERT-style post-LN blocks (the text encoders) and pre-LN blocks (ViT) with
learned positions, on ops.attention: key-padding masks stay on the fused
CUDA kernel path. The decoder (causal self-attention, cross-attention, KV
cache) arrives with the captioner slice and the MPNet relative position
bias with the retrieval slice; until then they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops.attention import (
    explicit_attention, multi_head_attention,
)


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-7
    is_decoder: bool = False         # causal self-attn + cross-attn
    pre_ln: bool = False             # pre-LN blocks (ViT-style); post-LN = BERT
    encoder_hidden_size: int = 0     # cross-attn K/V input dim (0 = hidden_size)
    fused_attn: bool = True
    compute_dtype: str = "bfloat16"
    # MPNet family (HF modeling_mpnet.py): bucketed relative position bias
    # shared across layers, RoBERTa-style position ids
    relative_bias_buckets: int = 0
    mpnet_positions: bool = False
    pad_token_id: int = 0
    # recompute each block in the backward (torch.utils.checkpoint); no
    # effect without gradients
    remat: bool = False

    @property
    def enc_dim(self) -> int:
        return self.encoder_hidden_size or self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _require_encoder(cfg: TransformerConfig) -> None:
    if cfg.is_decoder:
        raise NotImplementedError(
            "the transformer decoder arrives with the captioner slice")
    if cfg.relative_bias_buckets or cfg.mpnet_positions:
        raise NotImplementedError(
            "the MPNet relative bias and positions arrive with the "
            "retrieval slice")


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------

def init_embeddings(gen: torch.Generator, cfg: TransformerConfig
                    ) -> L.ParamTree:
    std = 0.02
    p = {
        "word": L.normal(gen, (cfg.vocab_size, cfg.hidden_size), std),
        "position": L.normal(gen, (cfg.max_position, cfg.hidden_size), std),
        "ln": L.layernorm_init(cfg.hidden_size),
    }
    if cfg.type_vocab_size:
        p["token_type"] = L.normal(
            gen, (cfg.type_vocab_size, cfg.hidden_size), std)
    return L.ParamTree(p)


def init_layer(gen: torch.Generator, cfg: TransformerConfig) -> L.ParamTree:
    _require_encoder(cfg)
    d, f = cfg.hidden_size, cfg.intermediate_size
    dims = {"q": (d, d), "k": (d, d), "v": (d, d), "attn_out": (d, d),
            "ffn_in": (d, f), "ffn_out": (f, d)}
    p = {n: L.linear_init(gen, *io) for n, io in dims.items()}
    p["ln1"] = L.layernorm_init(d)
    p["ln2"] = L.layernorm_init(d)
    return L.ParamTree(p)


def init_transformer(gen: torch.Generator, cfg: TransformerConfig
                     ) -> L.ParamTree:
    _require_encoder(cfg)
    return L.ParamTree({
        "embeddings": init_embeddings(gen, cfg),
        "layers": nn.ModuleList(init_layer(gen, cfg)
                                for _ in range(cfg.num_layers)),
    })


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def embed(params: L.ParamTree, cfg: TransformerConfig,
          input_ids: torch.Tensor,
          token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) int -> (B, T, D) in the compute dtype. Positions past the
    position table take its last row, as the JAX package's gather clamps
    them."""
    _require_encoder(cfg)
    table = params["position"]
    pos = torch.arange(input_ids.shape[1], device=table.device)
    e = params["word"][input_ids] + table[pos.clamp_max(table.shape[0] - 1)]
    if "token_type" in params:
        # segment 0 by default (HF semantics: token_type_ids default to 0)
        if token_type_ids is None:
            e = e + params["token_type"][0]
        else:
            e = e + params["token_type"][token_type_ids]
    e = L.layernorm(params["ln"], e, cfg.layer_norm_eps)
    return e.to(L.dtype_of(cfg.compute_dtype))


def _masked_attention(q, k, v, num_heads, mask, fused, key_mask=None):
    """mask: (B, 1, Tq, Tk) additive (-1e9 for masked) or None. key_mask:
    (B, Tk) {0,1} pure key padding, which stays on the fused kernel path;
    only causal/bias masks need the 4D slot, which runs the explicit path."""
    if mask is None:
        return multi_head_attention(q, k, v, num_heads, fused=fused,
                                    key_mask=key_mask)
    return explicit_attention(q, k, v, num_heads, mask)


def encoder_layer(p: L.ParamTree, cfg: TransformerConfig, x: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None,
                  encoder_states: Optional[torch.Tensor] = None,
                  cross_mask: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None,
                  key_mask: Optional[torch.Tensor] = None,
                  cross_key_mask: Optional[torch.Tensor] = None):
    """Transformer block, post-LN (BERT) or pre-LN (ViT). Returns
    (x, new_cache); new_cache is always None until the decoder is ported."""
    _require_encoder(cfg)
    if (encoder_states is not None or cross_mask is not None
            or cache is not None or cross_key_mask is not None):
        raise NotImplementedError(
            "cross-attention and the KV cache arrive with the captioner slice")
    dtype = L.dtype_of(cfg.compute_dtype)
    eps = cfg.layer_norm_eps
    if cfg.pre_ln:
        h = L.layernorm(p["ln1"], x, eps)
        q = L.linear(p["q"], h, dtype)
        k = L.linear(p["k"], h, dtype)
        v = L.linear(p["v"], h, dtype)
        ctx = _masked_attention(q, k, v, cfg.num_heads, attn_mask,
                                cfg.fused_attn, key_mask=key_mask)
        x = x + L.linear(p["attn_out"], ctx, dtype)
        h = L.layernorm(p["ln2"], x, eps)
        h = torch.nn.functional.gelu(L.linear(p["ffn_in"], h, dtype))
        return x + L.linear(p["ffn_out"], h, dtype), None
    q = L.linear(p["q"], x, dtype)
    k = L.linear(p["k"], x, dtype)
    v = L.linear(p["v"], x, dtype)
    ctx = _masked_attention(q, k, v, cfg.num_heads, attn_mask,
                            cfg.fused_attn, key_mask=key_mask)
    x = L.layernorm(p["ln1"], x + L.linear(p["attn_out"], ctx, dtype), eps)
    h = torch.nn.functional.gelu(L.linear(p["ffn_in"], x, dtype))
    h = L.linear(p["ffn_out"], h, dtype)
    return L.layernorm(p["ln2"], x + h, eps), None


def attention_mask_from_ids(attention_mask: torch.Tensor, tq: int
                            ) -> torch.Tensor:
    """(B, Tk) {0,1} -> additive (B, 1, tq, Tk) mask."""
    m = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
    return m.expand(attention_mask.shape[0], 1, tq, attention_mask.shape[1])


def transformer_forward(params: L.ParamTree, cfg: TransformerConfig,
                        input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None,
                        token_type_ids: Optional[torch.Tensor] = None,
                        encoder_states: Optional[torch.Tensor] = None,
                        encoder_mask: Optional[torch.Tensor] = None,
                        causal: bool = False) -> torch.Tensor:
    """Full-sequence encoder forward -> last_hidden_state (B, T, D)."""
    _require_encoder(cfg)
    if causal or encoder_states is not None or encoder_mask is not None:
        raise NotImplementedError(
            "causal and cross-attending stacks arrive with the captioner "
            "slice")
    x = embed(params["embeddings"], cfg, input_ids, token_type_ids)
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(p, x, key_mask):
        # pure key padding stays on the fused kernel path (boolean key mask)
        return encoder_layer(p, cfg, x, key_mask=key_mask)[0]

    for p in params["layers"]:
        x = (checkpoint(layer, p, x, attention_mask, use_reentrant=False)
             if remat else layer(p, x, attention_mask))
    return x
