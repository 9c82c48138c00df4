"""DeBERTa-v2/v3 encoder with disentangled attention, serving forward
(counterpart of mmd_tpu/models/deberta.py).

The reference's claim/document encoder is microsoft/deberta-v3-xsmall. Same
math as the JAX package: log-bucketed relative positions, shared-key
content<->position terms (c2p uses the key projection of the relative
embeddings, p2c the query projection), scale sqrt(3 * d_head), no absolute
positions, no token types.

Two attention paths, chosen as the JAX package chooses them
(`use_fused_attn`):
  * the kernel path `_disentangled_attention_fused`: projections and the
    diagonal tables PK/PQ here, everything (T x T)-shaped in
    `ops.deberta_attention.deberta_attention` (the CUDA kernel on the card);
  * the explicit path `_disentangled_attention`, which rounds the c2p/p2c
    products to the compute dtype and selects the diagonals as the JAX
    package's one-hot contraction does -- here as an index gather, which
    picks the same element without building the (T, 2T-1, T) one-hot.

The kernel path is differentiable: `deberta_attention` is an autograd
Function whose backward is the hand-written backward kernel (#11), so
fine-tuning keeps the kernel, as the JAX package does with fused_train (the
trainer takes the explicit path when fused_train is off). remat recomputes
each layer in the backward (torch.utils.checkpoint). The
sequence/pipeline-parallel variants and the HF converter arrive with later
slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops.deberta_attention import (
    deberta_attention, diagonal_index, split_heads,
)


@dataclasses.dataclass
class DebertaConfig:
    vocab_size: int = 128100
    hidden_size: int = 384           # deberta-v3-xsmall
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    max_position: int = 512          # max_relative_positions fallback
    position_buckets: int = 256
    layer_norm_eps: float = 1e-7
    share_att_key: bool = True       # v3: position terms reuse the q/k projections
    compute_dtype: str = "float32"
    fused_attn: bool = True          # the kernel path on CUDA tensors
    remat: bool = False              # recompute each layer in the backward
    # keep the kernels when fine-tuning: the backward kernel (#11) serves
    # the gradient; off, the trainer takes the explicit path
    # (training/trainer.py::make_finetune_raw_step, as in the JAX package)
    fused_train: bool = True

    @property
    def pos_ebd_size(self) -> int:
        return (self.position_buckets if self.position_buckets > 0
                else self.max_position)


DEBERTA_V3_XSMALL = DebertaConfig()
DEBERTA_TEST = DebertaConfig(vocab_size=120, hidden_size=32, num_layers=2,
                             num_heads=4, intermediate_size=64,
                             max_position=32, position_buckets=8)


# -- static relative-position tables (the port's own copies) -------------------

def make_log_bucket_position(rel_pos: np.ndarray, bucket_size: int,
                             max_position: int) -> np.ndarray:
    """Log-bucket mapping (HF modeling_deberta_v2.py semantics): positions
    within +-bucket/2 stay linear, beyond that they compress
    logarithmically into the remaining buckets."""
    sign = np.sign(rel_pos)
    mid = bucket_size // 2
    abs_pos = np.where((rel_pos < mid) & (rel_pos > -mid),
                       mid - 1, np.abs(rel_pos)).astype(np.float64)
    log_pos = (np.ceil(np.log(abs_pos / mid)
                       / math.log((max_position - 1) / mid) * (mid - 1))
               + mid)
    return np.where(np.abs(rel_pos) <= mid, rel_pos, (log_pos * sign)
                    ).astype(np.int64)


def build_relative_position(q_len: int, k_len: int, bucket_size: int,
                            max_position: int) -> np.ndarray:
    rel = np.arange(q_len)[:, None] - np.arange(k_len)[None, :]
    if bucket_size > 0 and max_position > 0:
        rel = make_log_bucket_position(rel, bucket_size, max_position)
    return rel.astype(np.int64)


def _diag_maps(t: int, cfg: DebertaConfig):
    """The bucketed index matrices are Toeplitz (functions of t - s alone).
    Returns (c2p_map, p2c_map), each (2T-1,) int: the relative-embedding row
    for diagonal position q, laid out so that out[t, s] uses
    map[T-1-t+s]."""
    span = cfg.pos_ebd_size
    q_idx = np.arange(2 * t - 1)
    d = t - 1 - q_idx                                  # diagonal value t - s
    bucket = make_log_bucket_position(d, cfg.position_buckets,
                                      cfg.max_position)
    c2p_map = np.clip(bucket + span, 0, span * 2 - 1)
    p2c_map = np.clip(-bucket + span, 0, span * 2 - 1)
    return c2p_map.astype(np.int32), p2c_map.astype(np.int32)


# -- init ----------------------------------------------------------------------

def init_deberta(gen: torch.Generator, cfg: DebertaConfig) -> L.ParamTree:
    d, f = cfg.hidden_size, cfg.intermediate_size
    std = 0.02
    return L.ParamTree({
        "embeddings": L.ParamTree({
            "word": L.normal(gen, (cfg.vocab_size, d), std),
            "ln": L.layernorm_init(d),
        }),
        "rel_embeddings": L.normal(gen, (cfg.pos_ebd_size * 2, d), std),
        "rel_ln": L.layernorm_init(d),
        "layers": nn.ModuleList(L.ParamTree({
            "q": L.linear_init(gen, d, d),
            "k": L.linear_init(gen, d, d),
            "v": L.linear_init(gen, d, d),
            "attn_out": L.linear_init(gen, d, d),
            "ln1": L.layernorm_init(d),
            "ffn_in": L.linear_init(gen, d, f),
            "ffn_out": L.linear_init(gen, f, d),
            "ln2": L.layernorm_init(d),
        }) for _ in range(cfg.num_layers)),
    })


# -- forward -------------------------------------------------------------------

def _disentangled_attention_fused(p: L.ParamTree, cfg: DebertaConfig,
                                  x: torch.Tensor, rel_emb: torch.Tensor,
                                  c2p_map: torch.Tensor, p2c_map: torch.Tensor,
                                  key_mask: Optional[torch.Tensor], dtype
                                  ) -> torch.Tensor:
    """Kernel path: projections and the (2T, D) diagonal tables here, the
    (T x T) work in `deberta_attention`."""
    dh = cfg.hidden_size // cfg.num_heads
    scale = 1.0 / math.sqrt(dh * 3.0)
    q = L.linear(p["q"], x, dtype)
    k = L.linear(p["k"], x, dtype)
    v = L.linear(p["v"], x, dtype)
    pos_k = L.linear(p["k"], rel_emb, dtype)               # (2*span, D)
    pos_q = L.linear(p["q"], rel_emb, dtype)
    pad = pos_k.new_zeros((1, cfg.hidden_size))
    pos_k_d = torch.cat([pos_k[c2p_map], pad])              # (2T, D)
    pos_q_d = torch.cat([pos_q[p2c_map], pad])
    ctx = deberta_attention(q, k, v, pos_k_d, pos_q_d, key_mask,
                            cfg.num_heads, scale)
    return L.linear(p["attn_out"], ctx, dtype)


def _disentangled_attention(p: L.ParamTree, cfg: DebertaConfig,
                            x: torch.Tensor, rel_emb: torch.Tensor,
                            c2p_map: torch.Tensor, p2c_map: torch.Tensor,
                            key_mask: Optional[torch.Tensor], dtype
                            ) -> torch.Tensor:
    """Explicit path, the JAX package's `_disentangled_attention`."""
    h = cfg.num_heads
    dh = cfg.hidden_size // h
    b, t, _ = x.shape
    scale = math.sqrt(dh * 3.0)   # scale_factor = 1 + len({c2p, p2c})

    q = split_heads(L.linear(p["q"], x, dtype), h).float()  # (B, h, T, dh)
    k = split_heads(L.linear(p["k"], x, dtype), h).float()
    v = split_heads(L.linear(p["v"], x, dtype), h)
    scores = (q @ k.transpose(-1, -2)) / scale

    pos_k = split_heads(L.linear(p["k"], rel_emb, dtype), h)  # (h, 2span, dh)
    pos_q = split_heads(L.linear(p["q"], rel_emb, dtype), h)
    pos_k_d = pos_k[:, c2p_map].float()                    # (h, 2T-1, dh)
    pos_q_d = pos_q[:, p2c_map].float()
    # c2p[t, j] = q_t . PK[j]; the reference rounds it to the compute dtype
    # and selects out[t, s] = c2p[t, T-1-t+s]
    c2p = (q @ pos_k_d.transpose(-1, -2)).to(dtype)        # (B, h, T, 2T-1)
    p2c = (k @ pos_q_d.transpose(-1, -2)).to(dtype)
    idx = diagonal_index(t, x.device).expand(b, h, t, t)
    c2p_sel = torch.gather(c2p, -1, idx).float()
    p2c_sel = torch.gather(p2c, -1, idx).float()
    scores = scores + c2p_sel / scale
    scores = scores + p2c_sel.transpose(-1, -2) / scale

    if key_mask is not None:
        scores = scores.masked_fill(~(key_mask != 0)[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1).to(dtype)
    ctx = (w.float() @ v.float()).to(dtype)
    ctx = ctx.transpose(1, 2).reshape(b, t, cfg.hidden_size)
    return L.linear(p["attn_out"], ctx, dtype)


def deberta_embed(params: L.ParamTree, cfg: DebertaConfig,
                  input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None):
    """(x, rel_emb): the embedded tokens and the LayerNormed shared
    relative-position table, both in the compute dtype."""
    dtype = L.dtype_of(cfg.compute_dtype)
    span = cfg.pos_ebd_size
    emb = params["embeddings"]
    x = L.layernorm(emb["ln"], emb["word"][input_ids], cfg.layer_norm_eps)
    if attention_mask is not None:
        x = x * attention_mask[..., None].to(x.dtype)
    rel_emb = L.layernorm(params["rel_ln"],
                          params["rel_embeddings"][: span * 2],
                          cfg.layer_norm_eps)
    return x.to(dtype), rel_emb.to(dtype)


def use_fused_attn(cfg: DebertaConfig, t: int, device: torch.device) -> bool:
    """The JAX package's gate, with "the tensors lie on CUDA" for "the
    backend is a TPU": D and 2T multiples of 128."""
    return (cfg.fused_attn and device.type == "cuda"
            and cfg.hidden_size % 128 == 0 and (2 * t) % 128 == 0)


def deberta_layer(p: L.ParamTree, cfg: DebertaConfig, x: torch.Tensor,
                  rel_emb: torch.Tensor, c2p_map, p2c_map,
                  attention_mask: Optional[torch.Tensor], dtype,
                  use_fused: bool) -> torch.Tensor:
    """One DeBERTa-v3 encoder block (disentangled attention + FFN)."""
    attn_fn = (_disentangled_attention_fused if use_fused
               else _disentangled_attention)
    dev = x.device
    a = attn_fn(p, cfg, x, rel_emb, torch.as_tensor(c2p_map, device=dev,
                                                   dtype=torch.long),
                torch.as_tensor(p2c_map, device=dev, dtype=torch.long),
                attention_mask, dtype)
    x = L.layernorm(p["ln1"], x + a, cfg.layer_norm_eps)
    # erf GELU in float32, tanh in bfloat16, as in layers.mlp
    hdn = F.gelu(L.linear(p["ffn_in"], x, dtype),
                 approximate="tanh" if dtype == torch.bfloat16 else "none")
    return L.layernorm(p["ln2"], x + L.linear(p["ffn_out"], hdn, dtype),
                       cfg.layer_norm_eps)


def deberta_encode(params: L.ParamTree, cfg: DebertaConfig,
                   input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """(B, T) token ids -> last_hidden_state (B, T, D)."""
    dtype = L.dtype_of(cfg.compute_dtype)
    t = input_ids.shape[1]
    dev = input_ids.device
    c2p_map, p2c_map = (torch.as_tensor(m, device=dev, dtype=torch.long)
                        for m in _diag_maps(t, cfg))
    x, rel_emb = deberta_embed(params, cfg, input_ids, attention_mask)
    fused = use_fused_attn(cfg, t, dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in params["layers"]:
        args = (p, cfg, x, rel_emb, c2p_map, p2c_map, attention_mask, dtype,
                fused)
        x = (checkpoint(deberta_layer, *args, use_reentrant=False) if remat
             else deberta_layer(*args))
    return x
