"""Transformer encoder stack (counterpart of mmd_tpu/models/transformer.py).

BERT-style post-LN blocks (the text encoders, the MiniLM cross-encoder)
and pre-LN blocks (ViT) with learned positions, on ops.attention:
key-padding masks stay on the fused CUDA kernel path. The MPNet family
(the retrieval bi-encoder) adds RoBERTa-style position ids and a bucketed
relative position bias shared by every layer; the bias rides the additive
mask slot, so its layers take the explicit path, as in the JAX package.

Decoder mode (the captioner's text decoder) adds causal self-attention,
cross-attention over encoder states and a static KV cache: (B, t_max, D)
tensors in the compute dtype, allocated once and written in place at the
cache's position, the counterpart of the JAX package's
dynamic_update_slice under lax.scan. The causal mask is additive, so
self-attention takes the explicit path; unmasked cross-attention takes
the fused kernel. A cache may also hold the cross-attention's K and V
("xk", "xv"), which depend on the encoder states only: a decode computes
them once a batch instead of once a step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

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
    d, f, e = cfg.hidden_size, cfg.intermediate_size, cfg.enc_dim
    dims = {"q": (d, d), "k": (d, d), "v": (d, d), "attn_out": (d, d),
            "ffn_in": (d, f), "ffn_out": (f, d)}
    if cfg.is_decoder:
        dims.update({"xq": (d, d), "xk": (e, d), "xv": (e, d),
                     "xattn_out": (d, d)})
    p = {n: L.linear_init(gen, *io) for n, io in dims.items()}
    p["ln1"] = L.layernorm_init(d)
    p["ln2"] = L.layernorm_init(d)
    if cfg.is_decoder:
        p["ln_x"] = L.layernorm_init(d)
    return L.ParamTree(p)


def init_transformer(gen: torch.Generator, cfg: TransformerConfig
                     ) -> L.ParamTree:
    p = {"embeddings": init_embeddings(gen, cfg),
         "layers": nn.ModuleList(init_layer(gen, cfg)
                                 for _ in range(cfg.num_layers))}
    if cfg.relative_bias_buckets:
        p["rel_bias"] = L.normal(
            gen, (cfg.relative_bias_buckets, cfg.num_heads), 0.02)
    return L.ParamTree(p)


# ----------------------------------------------------------------------------
# Forward
# ----------------------------------------------------------------------------

def embed(params: L.ParamTree, cfg: TransformerConfig,
          input_ids: torch.Tensor,
          token_type_ids: Optional[torch.Tensor] = None,
          position_offset: int = 0) -> torch.Tensor:
    """(B, T) int -> (B, T, D) in the compute dtype. Token t sits at
    position t + position_offset (a KV-cached decode step passes its
    position). Positions past the position table take its last row, as
    the JAX package's gather clamps them. With mpnet_positions
    (RoBERTa/MPNet, HF create_position_ids_from_input_ids) non-pad tokens
    are numbered pad_token_id + 1, + 2, ... and pads take the pad_token_id
    row; the offset does not apply."""
    table = params["position"]
    if cfg.mpnet_positions:
        not_pad = (input_ids != cfg.pad_token_id).long()
        pos = torch.cumsum(not_pad, dim=1) * not_pad + cfg.pad_token_id
    else:
        pos = torch.arange(position_offset,
                           position_offset + input_ids.shape[1],
                           device=table.device)
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


def cross_keys_values(p: L.ParamTree, cfg: TransformerConfig,
                      encoder_states: torch.Tensor) -> dict:
    """A decoder layer's cross-attention K and V over `encoder_states`
    ({"xk", "xv"}, (B, S, D) in the compute dtype): what encoder_layer
    computes from the encoder states, for a cache to hold."""
    dtype = L.dtype_of(cfg.compute_dtype)
    return {"xk": L.linear(p["xk"], encoder_states, dtype),
            "xv": L.linear(p["xv"], encoder_states, dtype)}


def encoder_layer(p: L.ParamTree, cfg: TransformerConfig, x: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None,
                  encoder_states: Optional[torch.Tensor] = None,
                  cross_mask: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None,
                  key_mask: Optional[torch.Tensor] = None,
                  cross_key_mask: Optional[torch.Tensor] = None,
                  tp=None):
    """Transformer block, post-LN (BERT) or pre-LN (ViT). Returns
    (x, new_cache).

    tp: a tensor-parallel axis (parallel/tp.TensorParallel) whose rank
    holds the column slices of q, k, v, ffn_in and the row slices of
    attn_out, ffn_out (tp.shard_encoder): attention runs on the rank's
    num_heads/tp heads (attn_mask, where given, holds those heads), and
    each row-split projection sums its partial products over the axis
    before its bias. An encoder block only.

    With a cache {"k", "v": (B, t_max, D), "idx": int}, this step's K and
    V are written in place at rows idx .. idx + T - 1 and attention runs
    over all t_max rows (attn_mask hides the unwritten ones); new_cache
    is the same tensors at idx + T. A decoder layer cross-attends to
    `encoder_states`, with the cache's "xk"/"xv" when it holds them."""
    dtype = L.dtype_of(cfg.compute_dtype)
    eps = cfg.layer_norm_eps
    heads = cfg.num_heads
    if tp is not None:
        if cfg.is_decoder:
            raise ValueError("tensor parallelism serves encoder blocks")
        heads //= tp.size
    if cfg.pre_ln:
        if cfg.is_decoder:
            raise ValueError("a pre-LN decoder is not implemented (nor in "
                             "the JAX package)")
        h = L.layernorm(p["ln1"], x, eps)
        q = L.linear(p["q"], h, dtype)
        k = L.linear(p["k"], h, dtype)
        v = L.linear(p["v"], h, dtype)
        ctx = _masked_attention(q, k, v, heads, attn_mask,
                                cfg.fused_attn, key_mask=key_mask)
        x = x + L.row_linear(p["attn_out"], ctx, dtype, tp)
        h = L.layernorm(p["ln2"], x, eps)
        h = torch.nn.functional.gelu(L.linear(p["ffn_in"], h, dtype))
        return x + L.row_linear(p["ffn_out"], h, dtype, tp), None
    q = L.linear(p["q"], x, dtype)
    k = L.linear(p["k"], x, dtype)
    v = L.linear(p["v"], x, dtype)
    new_cache = None
    if cache is not None:
        idx = cache["idx"]
        cache["k"][:, idx:idx + x.shape[1]] = k
        cache["v"][:, idx:idx + x.shape[1]] = v
        k, v = cache["k"], cache["v"]
        new_cache = {**cache, "idx": idx + x.shape[1]}
    ctx = _masked_attention(q, k, v, heads, attn_mask,
                            cfg.fused_attn, key_mask=key_mask)
    x = L.layernorm(p["ln1"], x + L.row_linear(p["attn_out"], ctx, dtype,
                                               tp), eps)
    if cfg.is_decoder and encoder_states is not None:
        xq = L.linear(p["xq"], x, dtype)
        if cache is not None and "xk" in cache:
            xk, xv = cache["xk"], cache["xv"]
        else:
            kv = cross_keys_values(p, cfg, encoder_states)
            xk, xv = kv["xk"], kv["xv"]
        xctx = _masked_attention(xq, xk, xv, cfg.num_heads, cross_mask,
                                 cfg.fused_attn, key_mask=cross_key_mask)
        x = L.layernorm(p["ln_x"], x + L.linear(p["xattn_out"], xctx, dtype),
                        eps)
    h = torch.nn.functional.gelu(L.linear(p["ffn_in"], x, dtype))
    h = L.row_linear(p["ffn_out"], h, dtype, tp)
    return L.layernorm(p["ln2"], x + h, eps), new_cache


def relative_position_bucket(t: int, num_buckets: int = 32,
                             max_distance: int = 128) -> np.ndarray:
    """(t, t) int32 bucket ids, exactly HF
    MPNetEncoder.relative_position_bucket (T5-style: half the buckets for
    each sign, half of those exact, log-spaced beyond)."""
    pos = np.arange(t, dtype=np.int64)
    n = pos[:, None] - pos[None, :]        # -(memory - context) = ctx - mem
    num_buckets //= 2
    ret = (n < 0).astype(np.int64) * num_buckets
    n = np.abs(n)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    with np.errstate(divide="ignore"):
        val_if_large = max_exact + (
            np.log(np.maximum(n, 1).astype(np.float32) / max_exact)
            / np.log(max_distance / max_exact) * (num_buckets - max_exact)
        ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    ret += np.where(is_small, n, val_if_large)
    return ret.astype(np.int32)


@functools.lru_cache(maxsize=16)
def _bucket_index(t: int, num_buckets: int, device: torch.device
                  ) -> torch.Tensor:
    """relative_position_bucket as an int64 tensor on `device`, made once a
    (length, table size, device)."""
    return torch.from_numpy(
        relative_position_bucket(t, num_buckets).astype(np.int64)).to(device)


def mpnet_position_bias(params: L.ParamTree, cfg: TransformerConfig,
                        t: int) -> torch.Tensor:
    """(1, H, T, T) fp32 additive bias shared by every layer (HF
    MPNetEncoder.compute_position_bias; the bucket count is the table size,
    independent of padding)."""
    table = params["rel_bias"]
    idx = _bucket_index(t, cfg.relative_bias_buckets, table.device)
    return table.float()[idx].permute(2, 0, 1)[None]


def attention_mask_from_ids(attention_mask: torch.Tensor, tq: int
                            ) -> torch.Tensor:
    """(B, Tk) {0,1} -> additive (B, 1, tq, Tk) mask."""
    m = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
    return m.expand(attention_mask.shape[0], 1, tq, attention_mask.shape[1])


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(1, 1, t, t) additive mask: -1e9 above the diagonal."""
    m = torch.ones(t, t, device=device).tril_()
    return ((1.0 - m) * -1e9)[None, None]


def transformer_forward(params: L.ParamTree, cfg: TransformerConfig,
                        input_ids: torch.Tensor,
                        attention_mask: Optional[torch.Tensor] = None,
                        token_type_ids: Optional[torch.Tensor] = None,
                        encoder_states: Optional[torch.Tensor] = None,
                        encoder_mask: Optional[torch.Tensor] = None,
                        causal: bool = False, tp=None) -> torch.Tensor:
    """Full-sequence forward -> last_hidden_state (B, T, D). A pure
    key-padding mask stays on the fused kernel path; a causal stack, or
    one with the MPNet bias, adds the padding to the additive mask, whose
    layers take the explicit path. A decoder cross-attends to
    `encoder_states` under the (B, S) key mask `encoder_mask`. tp: see
    encoder_layer; the MPNet bias keeps the rank's heads."""
    x = embed(params["embeddings"], cfg, input_ids, token_type_ids)
    t = x.shape[1]
    mask, key_mask = None, None
    if (attention_mask is not None and not causal
            and not cfg.relative_bias_buckets):
        key_mask = attention_mask
    elif attention_mask is not None:
        mask = attention_mask_from_ids(attention_mask, t)
    if causal:
        cm = causal_mask(t, x.device)
        mask = cm if mask is None else mask + cm
    if cfg.relative_bias_buckets:
        # the bias rides the additive-mask slot ((1,H,T,T) broadcasts
        # against (B,1,T,T)); its layers take the explicit path
        bias = mpnet_position_bias(params, cfg, t)
        if tp is not None:
            bias = bias[:, tp.heads(cfg.num_heads)]
        mask = bias if mask is None else mask + bias

    def layer(p, x, mask, key_mask, encoder_states, encoder_mask):
        return encoder_layer(p, cfg, x, mask, encoder_states,
                             key_mask=key_mask,
                             cross_key_mask=encoder_mask, tp=tp)[0]

    return L.run_layers(layer, params["layers"], x, mask, key_mask,
                        encoder_states, encoder_mask, remat=cfg.remat)
