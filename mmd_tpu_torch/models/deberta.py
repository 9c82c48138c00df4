"""DeBERTa-v2/v3 encoder with disentangled attention, serving forward
(counterpart of mmd_tpu/models/deberta.py).

The reference's claim/document encoder is microsoft/deberta-v3-xsmall. Same
math as the JAX package: log-bucketed relative positions, shared-key
content<->position terms (c2p uses the key projection of the relative
embeddings, p2c the query projection), scale sqrt(3 * d_head), no absolute
positions, no token types.

Two attention paths, chosen as the JAX package chooses them, within the
head dims the kernels take (`use_fused_attn`):
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
each layer in the backward (torch.utils.checkpoint). `config_from_hf` and
`load_hf_deberta_state_dict` read a HF DeBERTa-v3 download
(mmd_tpu_torch/convert_hf.py). Under tensor parallelism (`tp=`) a layer
runs its attention on the rank's heads; the sequence-parallel layer
(`deberta_layer_sp`) and its ring variant serve parallel/sp.py, on the
explicit path, as in the JAX package, and differentiate through the
collectives autograd sees (parallel/collectives.py): the shared relative
table and the position projections of it collect this rank's part of
their gradient.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops.deberta_attention import (
    _HEAD_DIMS, deberta_attention, diagonal_index, key_bytes, split_heads,
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
    (T x T) work in `deberta_attention`. -> the context (B, T, D), before
    the output projection."""
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
    return deberta_attention(q, k, v, pos_k_d, pos_q_d, key_mask,
                             cfg.num_heads, scale)


def _disentangled_attention(p: L.ParamTree, cfg: DebertaConfig,
                            x: torch.Tensor, rel_emb: torch.Tensor,
                            c2p_map: torch.Tensor, p2c_map: torch.Tensor,
                            key_mask: Optional[torch.Tensor], dtype
                            ) -> torch.Tensor:
    """Explicit path, the JAX package's `_disentangled_attention`. -> the
    context (B, T, D), before the output projection."""
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
    return ctx.transpose(1, 2).reshape(b, t, cfg.hidden_size)


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
    backend is a TPU": D and 2T multiples of 128; narrowed to the head
    dims kernels #10 and #11 take. Any other geometry takes the explicit
    path."""
    return (cfg.fused_attn and device.type == "cuda"
            and cfg.hidden_size % 128 == 0 and (2 * t) % 128 == 0
            and cfg.hidden_size % cfg.num_heads == 0
            and cfg.hidden_size // cfg.num_heads in _HEAD_DIMS)


def _ffn(p: L.ParamTree, cfg: DebertaConfig, x: torch.Tensor, a, dtype,
         tp=None) -> torch.Tensor:
    """The block after its attention: residual, LayerNorm, FFN, residual,
    LayerNorm; `a` is the attention's context before its projection."""
    x = L.layernorm(p["ln1"], x + L.row_linear(p["attn_out"], a, dtype, tp),
                    cfg.layer_norm_eps)
    # erf GELU in float32, tanh in bfloat16, as in layers.mlp
    hdn = F.gelu(L.linear(p["ffn_in"], x, dtype),
                 approximate="tanh" if dtype == torch.bfloat16 else "none")
    return L.layernorm(p["ln2"],
                       x + L.row_linear(p["ffn_out"], hdn, dtype, tp),
                       cfg.layer_norm_eps)


def deberta_layer(p: L.ParamTree, cfg: DebertaConfig, x: torch.Tensor,
                  rel_emb: torch.Tensor, c2p_map, p2c_map,
                  attention_mask: Optional[torch.Tensor], dtype,
                  use_fused: bool, tp=None) -> torch.Tensor:
    """One DeBERTa-v3 encoder block (disentangled attention + FFN).

    tp: a tensor-parallel axis (parallel/tp.TensorParallel) whose rank holds
    the column slices of q, k, v, ffn_in and the row slices of attn_out,
    ffn_out (tp.shard_encoder): the attention runs on the rank's h/tp heads
    (the kernel, where `use_fused`, on that local geometry), and each
    row-split projection sums its partial products over the axis before
    its bias. None: the whole layer here."""
    attn_fn = (_disentangled_attention_fused if use_fused
               else _disentangled_attention)
    dev = x.device
    a = attn_fn(p, cfg if tp is None else tp.local_config(cfg), x, rel_emb,
                torch.as_tensor(c2p_map, device=dev, dtype=torch.long),
                torch.as_tensor(p2c_map, device=dev, dtype=torch.long),
                attention_mask, dtype)
    return _ffn(p, cfg, x, a, dtype, tp)


def deberta_encode(params: L.ParamTree, cfg: DebertaConfig,
                   input_ids: torch.Tensor,
                   attention_mask: Optional[torch.Tensor] = None,
                   tp=None) -> torch.Tensor:
    """(B, T) token ids -> last_hidden_state (B, T, D). tp: see
    deberta_layer (the gate reads the model's width and head dim)."""
    dtype = L.dtype_of(cfg.compute_dtype)
    t = input_ids.shape[1]
    dev = input_ids.device
    c2p_map, p2c_map = (torch.as_tensor(m, device=dev, dtype=torch.long)
                        for m in _diag_maps(t, cfg))
    x, rel_emb = deberta_embed(params, cfg, input_ids, attention_mask)
    fused = use_fused_attn(cfg, t, dev)
    key_mask = attention_mask
    if fused and key_mask is not None:
        key_mask = key_bytes(key_mask)      # the kernels' view, once a call

    def layer(p, x, rel_emb, key_mask):
        return deberta_layer(p, cfg, x, rel_emb, c2p_map, p2c_map, key_mask,
                             dtype, fused, tp)

    return L.run_layers(layer, params["layers"], x, rel_emb, key_mask,
                        remat=cfg.remat)


# -- sequence parallelism (parallel/sp.py) ---------------------------------------

def _gather_diagonal(x: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, t: int) -> torch.Tensor:
    """out[..., r, c] = x[..., r, T-1-rows[r]+cols[c]]: the one-hot
    selection onehot[r, j, c] = (j == T-1-rows[r]+cols[c]) of the JAX
    package, rows and cols the absolute positions, as an index gather."""
    idx = (t - 1) - rows[:, None] + cols[None, :]
    return torch.gather(x, -1, idx.expand(*x.shape[:-1], cols.numel()))


def _sp_tables(p, cfg: DebertaConfig, rel_emb, c2p_map, p2c_map, dtype):
    """The diagonal tables PK, PQ (h, 2T-1, dh) in fp32."""
    h = cfg.num_heads
    pos_k = split_heads(L.linear(p["k"], rel_emb, dtype), h)
    pos_q = split_heads(L.linear(p["q"], rel_emb, dtype), h)
    return pos_k[:, c2p_map].float(), pos_q[:, p2c_map].float()


def _disentangled_attention_sp(p, cfg: DebertaConfig, x_loc, rel_emb,
                               c2p_map, p2c_map, key_mask_full, dtype, mesh,
                               axis: str, t_full: int, row_offset: int):
    """Sequence-parallel variant of _disentangled_attention: x_loc holds
    this rank's T/sp query rows (absolute offset `row_offset`); K/V are
    computed locally and all-gathered over `axis` to full T. The diagonal
    selections are rebuilt from the absolute row positions, so every rank
    picks exactly its rows of the unsplit selection. -> the context
    (B, tl, D)."""
    from mmd_tpu_torch.parallel import collectives as C
    h = cfg.num_heads
    dh = cfg.hidden_size // h
    b, tl, _ = x_loc.shape
    t = t_full
    scale = math.sqrt(dh * 3.0)

    q = split_heads(L.linear(p["q"], x_loc, dtype), h).float()  # (B,h,tl,dh)
    k = C.all_gather_grad(split_heads(L.linear(p["k"], x_loc, dtype), h),
                          mesh, axis, dim=2).float()            # (B,h,T,dh)
    v = C.all_gather_grad(split_heads(L.linear(p["v"], x_loc, dtype), h),
                          mesh, axis, dim=2)
    scores = (q @ k.transpose(-1, -2)) / scale                  # (B,h,tl,T)
    pos_k_d, pos_q_d = _sp_tables(p, cfg, rel_emb, c2p_map, p2c_map, dtype)
    c2p = (q @ pos_k_d.transpose(-1, -2)).to(dtype)             # local rows
    p2c = (k @ pos_q_d.transpose(-1, -2)).to(dtype)             # every key
    q_pos = torch.arange(tl, device=x_loc.device) + row_offset
    k_pos = torch.arange(t, device=x_loc.device)
    scores = scores + _gather_diagonal(c2p, q_pos, k_pos, t).float() / scale
    scores = scores + _gather_diagonal(p2c, k_pos, q_pos, t).float(
    ).transpose(-1, -2) / scale
    if key_mask_full is not None:
        scores = scores.masked_fill(~(key_mask_full != 0)[:, None, None, :],
                                    torch.finfo(torch.float32).min)
    w = torch.softmax(scores, dim=-1).to(dtype)
    ctx = (w.float() @ v.float()).to(dtype)
    return ctx.transpose(1, 2).reshape(b, tl, cfg.hidden_size)


def _disentangled_attention_ring(p, cfg: DebertaConfig, x_loc, rel_emb,
                                 c2p_map, p2c_map, key_mask_full, dtype,
                                 mesh, axis: str, t_full: int, sp: int,
                                 rank: int):
    """Ring variant of _disentangled_attention_sp: the K/V blocks rotate
    around the ring (ppermute) under an online softmax, so a rank holds one
    (B, h, T/sp, dh) block at a time. The content-to-position term is
    computed once for the local rows; each block's selections (its c2p
    columns, the p2c term of the arriving K block) are rebuilt from the
    block's absolute origin (rank - step) mod sp. Same math as the unsplit
    attention up to fp reassociation. -> the context (B, tl, D)."""
    from mmd_tpu_torch.parallel import collectives as C
    h = cfg.num_heads
    dh = cfg.hidden_size // h
    b, tl, _ = x_loc.shape
    t = t_full
    scale = math.sqrt(dh * 3.0)
    dev = x_loc.device

    q = split_heads(L.linear(p["q"], x_loc, dtype), h).float()  # (B,h,tl,dh)
    kh = split_heads(L.linear(p["k"], x_loc, dtype), h)
    vh = split_heads(L.linear(p["v"], x_loc, dtype), h)
    pos_k_d, pos_q_d = _sp_tables(p, cfg, rel_emb, c2p_map, p2c_map, dtype)
    c2p = (q @ pos_k_d.transpose(-1, -2)).to(dtype)    # (B,h,tl,2T-1), once
    q_pos = torch.arange(tl, device=dev) + rank * tl
    neg = torch.finfo(torch.float32).min

    m = torch.full((b, h, tl, 1), -math.inf, device=dev)
    lsum = torch.zeros((b, h, tl, 1), device=dev)
    o = torch.zeros((b, h, tl, dh), device=dev)
    perm = [(s, (s + 1) % sp) for s in range(sp)]
    for step in range(sp):
        src = (rank - step) % sp
        k_pos = torch.arange(tl, device=dev) + src * tl    # block's keys
        s_blk = q @ kh.float().transpose(-1, -2)
        s_blk = s_blk + _gather_diagonal(c2p, q_pos, k_pos, t).float()
        # p2c from the arriving K block: its rows are the block's keys
        p2c = (kh.float() @ pos_q_d.transpose(-1, -2)).to(dtype)
        s_blk = (s_blk + _gather_diagonal(p2c, k_pos, q_pos, t).float()
                 .transpose(-1, -2)) / scale
        if key_mask_full is not None:
            valid = key_mask_full[:, src * tl:(src + 1) * tl] != 0
            s_blk = s_blk.masked_fill(~valid[:, None, None, :], neg)
        m_new = torch.maximum(m, s_blk.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        pw = torch.exp(s_blk - m_new)
        lsum = lsum * corr + pw.sum(-1, keepdim=True)
        o = o * corr + pw.to(vh.dtype).float() @ vh.float()
        m = m_new
        if step < sp - 1:
            kh = C.ppermute_grad(kh, mesh, axis, perm)
            vh = C.ppermute_grad(vh, mesh, axis, perm)
    ctx = (o / lsum).to(dtype)
    return ctx.transpose(1, 2).reshape(b, tl, cfg.hidden_size)


def deberta_layer_sp(p: L.ParamTree, cfg: DebertaConfig, x_loc, rel_emb,
                     c2p_map, p2c_map, key_mask_full, dtype, mesh, axis: str,
                     t_full: int, row_offset: int, sp: int = 0,
                     rank: Optional[int] = None,
                     ring: bool = False) -> torch.Tensor:
    """deberta_layer with sequence-parallel attention; LN/FFN per token.
    ring=True rotates the K/V blocks under an online softmax
    (_disentangled_attention_ring) instead of the per-layer all-gather."""
    if ring:
        a = _disentangled_attention_ring(p, cfg, x_loc, rel_emb, c2p_map,
                                         p2c_map, key_mask_full, dtype, mesh,
                                         axis, t_full, sp, rank)
    else:
        a = _disentangled_attention_sp(p, cfg, x_loc, rel_emb, c2p_map,
                                       p2c_map, key_mask_full, dtype, mesh,
                                       axis, t_full, row_offset)
    return _ffn(p, cfg, x_loc, a, dtype)


# -- HF conversion ---------------------------------------------------------------

def _att_types(value) -> set[str]:
    return set(value.split("|") if isinstance(value, str) else value or ())


def config_from_hf(config_json: Mapping) -> DebertaConfig:
    """The DebertaConfig of a HF DeBERTa-v2/v3 `config.json` (a dict),
    with tools/convert_hf.py's rules: max_relative_positions < 1 takes
    max_position_embeddings, and the position terms must share the
    attention's key (share_att_key, as in v3). Variants the encoder does
    not compute (absolute positions, no relative attention, other position
    terms or another activation) raise. The compute dtype stays float32,
    as the JAX package's converter leaves it."""
    c = config_json
    if not c.get("share_att_key", False):
        raise ValueError("only share_att_key=true DeBERTa (v3) converts")
    if (c.get("position_biased_input", True)
            or not c.get("relative_attention", False)
            or _att_types(c.get("pos_att_type")) != {"c2p", "p2c"}
            or "layer_norm" not in c.get("norm_rel_ebd", "none")
            or c.get("hidden_act", "gelu") != "gelu"):
        raise ValueError(
            "the encoder computes DeBERTa-v3's attention only: relative "
            "attention with c2p and p2c, a LayerNormed relative table, no "
            "absolute positions, GELU")
    max_rel = c.get("max_relative_positions", -1)
    if max_rel < 1:
        max_rel = c["max_position_embeddings"]
    return DebertaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"], max_position=max_rel,
        position_buckets=c.get("position_buckets", -1),
        layer_norm_eps=c.get("layer_norm_eps", 1e-7), share_att_key=True)


def load_hf_deberta_state_dict(state_dict: Mapping, cfg: DebertaConfig
                               ) -> L.ParamTree:
    """A HF DebertaV2Model state dict (torch or numpy values, no task
    prefix) as the port's encoder params."""
    get = functools.partial(L.hf_tensor, state_dict)
    tensors = {"embeddings.word": get("embeddings.word_embeddings.weight"),
               "rel_embeddings": get("encoder.rel_embeddings.weight"),
               **L.hf_modules(state_dict, {
                   "embeddings.ln": "embeddings.LayerNorm",
                   "rel_ln": "encoder.LayerNorm"})}
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}"
        tensors.update(L.hf_modules(state_dict, {
            f"layers.{i}.q": f"{pre}.attention.self.query_proj",
            f"layers.{i}.k": f"{pre}.attention.self.key_proj",
            f"layers.{i}.v": f"{pre}.attention.self.value_proj",
            f"layers.{i}.attn_out": f"{pre}.attention.output.dense",
            f"layers.{i}.ln1": f"{pre}.attention.output.LayerNorm",
            f"layers.{i}.ffn_in": f"{pre}.intermediate.dense",
            f"layers.{i}.ffn_out": f"{pre}.output.dense",
            f"layers.{i}.ln2": f"{pre}.output.LayerNorm"}))
    params = init_deberta(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, tensors, "deberta")
