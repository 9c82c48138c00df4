"""DeBERTa-v3 disentangled attention for the serving path: a hand-written
CUDA kernel and its plain PyTorch version.

Counterpart of mmd_tpu/models/deberta.py::_deberta_attn_fused. The caller
passes the projected q, k, v (B, T, D), the diagonal tables PK and PQ
(2T, D) -- the key and the query projection of the relative embeddings,
gathered by the c2p and p2c maps and padded with one row -- and a (B, T)
key mask. Per head, for query t and key s:

    score[t, s] = (q_t.k_s + q_t.PK[T-1-t+s] + k_s.PQ[T-1-s+t]) * scale

then a masked key's score becomes finfo(float32).min (not -inf: a row with
no valid key gets the uniform mean of V), softmax over s, and P.V. Scores
are fp32; the TPU kernel's bf16 score rounding (LOWP_SCORES) is not
reproduced.

  * CUDA tensors go to the kernel (ops/csrc/deberta_attn_fwd.cu): head dims
    32 and 64, T a multiple of 64, float32 or bfloat16; it raises on the
    rest.
  * CPU tensors go to `deberta_attention_plain`.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the disentangled-attention kernel in this process; a run
# resets it to 0 and reads it back to show which path its attentions took.
launches = 0
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


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library(
        "deberta_attn_fwd", ["deberta_attn_fwd.cu"]).mmd_deberta_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
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


def deberta_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos_k_d: torch.Tensor, pos_q_d: torch.Tensor,
                      key_mask: Optional[torch.Tensor], num_heads: int,
                      scale: float) -> torch.Tensor:
    """Disentangled attention (see the module docstring) -> (B, T, D).
    key_mask: (B, T), nonzero = valid key, or None for all valid."""
    if q.device.type == "cpu":
        return deberta_attention_plain(q, k, v, pos_k_d, pos_q_d, key_mask,
                                       num_heads, scale)
    if q.device.type != "cuda":
        raise ValueError(f"deberta_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _deberta_attention_cuda(q, k, v, pos_k_d, pos_q_d, key_mask,
                                   num_heads, scale)
