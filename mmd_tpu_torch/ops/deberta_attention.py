"""DeBERTa-v3 disentangled attention: hand-written CUDA kernels for the
forward and the backward, and their plain PyTorch versions.

Counterpart of mmd_tpu/models/deberta.py::_deberta_attn_trainable, the
forward _deberta_attn_fused under a custom VJP whose backward is
_deberta_attn_fused_bwd_call. The caller
passes the projected q, k, v (B, T, D), the diagonal tables PK and PQ
(2T, D) -- the key and the query projection of the relative embeddings,
gathered by the c2p and p2c maps and padded with one row -- and a (B, T)
key mask. Per head, for query t and key s:

    score[t, s] = (q_t.k_s + q_t.PK[T-1-t+s] + k_s.PQ[T-1-s+t]) * scale

then a masked key's score becomes finfo(float32).min (not -inf: a row with
no valid key gets the uniform mean of V), softmax over s, and P.V. Scores
are fp32; the TPU kernel's bf16 score rounding (LOWP_SCORES) is not
reproduced.

  * CUDA tensors go to the kernels (ops/csrc/deberta_attn_fwd.cu and
    deberta_attn_bwd.cu): head dims 32 and 64, T a multiple of 64, float32
    or bfloat16; they raise on the rest.
  * CPU tensors go to `deberta_attention_plain` and
    `deberta_attention_bwd_plain`.
`deberta_attention` is a torch.autograd.Function over the two: its
backward recomputes the scores from the saved operands and returns dq, dk,
dv and the tables' gradients dPK, dPQ (summed over the batch).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the forward and the backward kernels in this process; a run
# resets them to 0 and reads them back to show which path its attentions
# took.
launches = 0
bwd_launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_TILE = 64


def diagonal_index(t: int, device=None) -> torch.Tensor:
    """(T, T) long: index[t, s] = T-1-t+s, the diagonal of (t, s)."""
    r = torch.arange(t, device=device)
    return t - 1 - r[:, None] + r[None, :]


def split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """(..., N, D) -> (..., h, N, dh)."""
    *lead, n, d = x.shape
    return x.reshape(*lead, n, h, d // h).transpose(-3, -2)


def deberta_attention_plain(q, k, v, pos_k_d, pos_q_d,
                            key_mask: Optional[torch.Tensor], num_heads: int,
                            scale: float) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 throughout, with the
    diagonal selection as an index gather. -> (B, T, D) in q's dtype."""
    b, t, d = q.shape
    qh, kh, vh = (split_heads(x.float(), num_heads) for x in (q, k, v))
    pkh = split_heads(pos_k_d.float(), num_heads)           # (h, 2T, dh)
    pqh = split_heads(pos_q_d.float(), num_heads)
    idx = diagonal_index(t, q.device).expand(b, num_heads, t, t)
    c2p = torch.gather(qh @ pkh.transpose(-1, -2), -1, idx)
    p2c = torch.gather(kh @ pqh.transpose(-1, -2), -1, idx)
    s = (qh @ kh.transpose(-1, -2) + c2p + p2c.transpose(-1, -2)) * scale
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        s = s.masked_fill(~valid, torch.finfo(torch.float32).min)
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def deberta_attention_bwd_plain(q, k, v, pos_k_d, pos_q_d,
                                key_mask: Optional[torch.Tensor], do,
                                num_heads: int, scale: float):
    """The backward kernel's function in plain PyTorch, fp32 throughout, from
    the formulas of mmd_tpu/models/deberta.py:325-337:

        ds   = P (dP - rowsum(dP P)) * scale, 0 for masked keys
        dv   = P^T dO,  dq = ds K + dC2P PK,  dk = ds^T Q + dP2C PQ
        dPK  = sum_b dC2P^T Q,  dPQ = sum_b dP2C^T K

    where dC2P[t, T-1-t+s] = ds[t, s] and dP2C[s, T-1-s+t] = ds[t, s] put
    each weight back on its diagonal. -> (dq, dk, dv) in q's dtype and
    (dPK, dPQ) (2T, D) fp32."""
    b, t, d = q.shape
    h = num_heads
    qh, kh, vh, doh = (split_heads(x.float(), h) for x in (q, k, v, do))
    pkh = split_heads(pos_k_d.float(), h)                   # (h, 2T, dh)
    pqh = split_heads(pos_q_d.float(), h)
    idx = diagonal_index(t, q.device).expand(b, h, t, t)
    c2p = torch.gather(qh @ pkh.transpose(-1, -2), -1, idx)
    p2c = torch.gather(kh @ pqh.transpose(-1, -2), -1, idx)
    s = (qh @ kh.transpose(-1, -2) + c2p + p2c.transpose(-1, -2)) * scale
    valid = None
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        s = s.masked_fill(~valid, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    dv = p.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    if valid is not None:
        ds = ds.masked_fill(~valid, 0.0)
    wide = (b, h, t, 2 * t)
    dc2p = torch.zeros(wide, device=q.device).scatter(-1, idx, ds)
    dp2c = torch.zeros(wide, device=q.device).scatter(
        -1, idx, ds.transpose(-1, -2))
    dq = ds @ kh + dc2p @ pkh
    dk = ds.transpose(-1, -2) @ qh + dp2c @ pqh
    dpk = (dc2p.transpose(-1, -2) @ qh).sum(0)              # (h, 2T, dh)
    dpq = (dp2c.transpose(-1, -2) @ kh).sum(0)

    def merge(x):
        return x.transpose(-3, -2).reshape(*x.shape[:-3], x.shape[-2], d)

    return (*(merge(x).to(q.dtype) for x in (dq, dk, dv)), merge(dpk),
            merge(dpq))


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library(
        "deberta_attn_fwd", ["deberta_attn_fwd.cu"]).mmd_deberta_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def load_bwd_kernel():
    """Build (at first use) and load the backward kernels; returns their C
    entry point."""
    fn = cuda_build.load_library(
        "deberta_attn_bwd", ["deberta_attn_bwd.cu"]).mmd_deberta_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_inputs(q, k, v, pos_k_d, pos_q_d, key_mask, num_heads):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, D) of one shape, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, t, d = q.shape
    if t % _TILE:
        raise ValueError(f"the kernel takes T a multiple of {_TILE}, not {t}")
    if d % num_heads or d // num_heads not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}; D={d} "
                         f"over {num_heads} heads")
    for name, tab in (("pos_k_d", pos_k_d), ("pos_q_d", pos_q_d)):
        if tuple(tab.shape) != (2 * t, d):
            raise ValueError(f"{name} must be (2T, D) = {(2 * t, d)}, not "
                             f"{tuple(tab.shape)}")
    tensors = (q, k, v, pos_k_d, pos_q_d)
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in tensors):
        raise ValueError(f"the kernel takes float32 or bfloat16 tensors of one "
                         f"dtype, not {[x.dtype for x in tensors]}")
    if tuple(key_mask.shape) != (b, t):
        raise ValueError(f"key_mask must be (B, T) = {(b, t)}, not "
                         f"{tuple(key_mask.shape)}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(x.device != q.device for x in (*tensors, key_mask)):
        raise ValueError("the inputs lie on different devices")


def _deberta_attention_cuda(q, k, v, pos_k_d, pos_q_d, key_mask, num_heads,
                            scale):
    global launches
    b, t, d = q.shape
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.uint8, device=q.device)
    _check_kernel_inputs(q, k, v, pos_k_d, pos_q_d, key_mask, num_heads)
    valid = (key_mask != 0).to(torch.uint8).contiguous()
    o = torch.empty_like(q)
    cuda_build.check_aligned(q, k, v, pos_k_d, pos_q_d, o)
    fn = load_kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_k_d.data_ptr(),
            pos_q_d.data_ptr(), valid.data_ptr(), o.data_ptr(), b, t,
            num_heads, d // num_heads, scale, _DTYPE_CODES[q.dtype],
            cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(rc, f"deberta_attn_fwd {tuple(q.shape)} "
                                f"{num_heads} heads {q.dtype}")
    with _launch_lock:
        launches += 1
    return o


def _deberta_attention_bwd_cuda(q, k, v, pos_k_d, pos_q_d, key_mask, do,
                                num_heads, scale):
    global bwd_launches
    b, t, d = q.shape
    if key_mask is None:
        key_mask = torch.ones((b, t), dtype=torch.uint8, device=q.device)
    _check_kernel_inputs(q, k, v, pos_k_d, pos_q_d, key_mask, num_heads)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError("do must be a contiguous tensor of q's shape, dtype "
                         "and device")
    valid = (key_mask != 0).to(torch.uint8).contiguous()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    dpk, dpq = torch.empty((2 * t, d), **f32), torch.empty((2 * t, d), **f32)
    stats = torch.empty((3, b, num_heads, t), **f32)
    # the dq and dkdv passes' band slices: (T + 64) rows per (b, tile)
    ws = torch.zeros((2, b, t // _TILE, t + 64, d), **f32)
    cuda_build.check_aligned(q, k, v, pos_k_d, pos_q_d, do, dq, dk, dv, dpk,
                             dpq, ws)
    fn = load_bwd_kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_k_d.data_ptr(),
            pos_q_d.data_ptr(), valid.data_ptr(), do.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dpk.data_ptr(), dpq.data_ptr(), b, t, num_heads,
            d // num_heads, scale, _DTYPE_CODES[q.dtype],
            cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(rc, f"deberta_attn_bwd {tuple(q.shape)} "
                                f"{num_heads} heads {q.dtype}")
    with _launch_lock:
        bwd_launches += 1
    return dq, dk, dv, dpk, dpq


def deberta_attention_fwd(q, k, v, pos_k_d, pos_q_d, key_mask, num_heads,
                          scale) -> torch.Tensor:
    """The forward without autograd: the kernel on CUDA tensors, the plain
    version on CPU ones."""
    if cuda_build.on_cuda(q, "deberta_attention"):
        return _deberta_attention_cuda(q, k, v, pos_k_d, pos_q_d, key_mask,
                                       num_heads, scale)
    return deberta_attention_plain(q, k, v, pos_k_d, pos_q_d, key_mask,
                                   num_heads, scale)


def deberta_attention_bwd(q, k, v, pos_k_d, pos_q_d, key_mask, do,
                          num_heads, scale):
    """The backward -> (dq, dk, dv, dPK, dPQ): the kernels on CUDA tensors,
    `deberta_attention_bwd_plain` on CPU ones."""
    if cuda_build.on_cuda(q, "deberta_attention_bwd"):
        return _deberta_attention_bwd_cuda(q, k, v, pos_k_d, pos_q_d,
                                           key_mask, do, num_heads, scale)
    return deberta_attention_bwd_plain(q, k, v, pos_k_d, pos_q_d, key_mask,
                                       do, num_heads, scale)


class _DebertaAttention(torch.autograd.Function):
    """Forward kernel, backward kernel; the residuals are the operands, as
    in _deberta_attn_trainable_fwd. The tables' gradients come back in the
    tables' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, pos_k_d, pos_q_d, key_mask, num_heads, scale):
        ctx.save_for_backward(q, k, v, pos_k_d, pos_q_d, key_mask)
        ctx.num_heads, ctx.scale = num_heads, scale
        return deberta_attention_fwd(q, k, v, pos_k_d, pos_q_d, key_mask,
                                     num_heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos_k_d, pos_q_d, key_mask = ctx.saved_tensors
        dq, dk, dv, dpk, dpq = deberta_attention_bwd(
            q, k, v, pos_k_d, pos_q_d, key_mask, g.to(q.dtype).contiguous(),
            ctx.num_heads, ctx.scale)
        return (dq, dk, dv, dpk.to(pos_k_d.dtype), dpq.to(pos_q_d.dtype),
                None, None, None)


def deberta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos_k_d: torch.Tensor, pos_q_d: torch.Tensor,
                      key_mask: Optional[torch.Tensor], num_heads: int,
                      scale: float) -> torch.Tensor:
    """Disentangled attention (see the module docstring) -> (B, T, D),
    differentiable in q, k, v and both tables. key_mask: (B, T), nonzero =
    valid key, or None for all valid."""
    return _DebertaAttention.apply(q, k, v, pos_k_d, pos_q_d, key_mask,
                                   num_heads, float(scale))
