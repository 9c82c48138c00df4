"""Multi-head attention: a hand-written CUDA flash-attention forward, and
the plain PyTorch paths.

Counterpart of mmd_tpu/ops/attention.py. The caller passes ALREADY-PROJECTED
q (B, T, D) and k/v (B, S, D); this op splits heads, computes
softmax(q k^T / sqrt(dh)) v (non-causal) and merges heads back; the caller
applies the output projection.

Three functions compute it:
  * `flash_attention` — the kernel (ops/csrc/flash_attn_fwd.cu) for CUDA
    tensors, `flash_attention_plain` for CPU tensors. Key-masked rows with
    no valid key give zeros, as the TPU kernel's do.
  * `flash_attention_plain` — the same function in plain PyTorch, in fp32.
    The CPU runs it, and the kernel is held against it.
  * `attention_reference` and the additive-mask path of
    `multi_head_attention(fused=False)` — the reference's explicit path: a
    -1e9 key bias, so a row with no valid key becomes a uniform softmax,
    exactly as the JAX jnp fallback behaves.

Softmax statistics are fp32 whatever the compute dtype. Attention dropout
belongs to training and is not ported yet: asking for it raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the flash-attention kernel in this process; a run resets it to
# 0 and reads it back to show which path its attentions took.
launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _no_dropout(dropout_rate: float, deterministic: bool) -> None:
    if dropout_rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "attention dropout is part of the training slice, not ported yet")


def explicit_attention(q, k, v, num_heads: int,
                       bias: Optional[torch.Tensor] = None):
    """The reference's explicit path: fp32 scores from the compute-dtype
    inputs, an optional additive fp32 bias broadcastable to (B, H, T, S),
    fp32 softmax, weights rounded to v's dtype, fp32 accumulation of P.V."""
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    dh = qh.shape[-1]
    scores = (qh.float() @ kh.float().transpose(-1, -2)) / math.sqrt(dh)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1).to(vh.dtype)
    ctx = w.float() @ vh.float()
    return _merge_heads(ctx).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, dropout_rate: float = 0.0,
                        deterministic: bool = True) -> torch.Tensor:
    """Explicit attention over (B, T, D) q and (B, S, D) k/v -> (B, T, D)."""
    _no_dropout(dropout_rate, deterministic)
    return explicit_attention(q, k, v, num_heads)


# ----------------------------------------------------------------------------
# The flash-attention forward: kernel and plain version
# ----------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int,
                          key_mask: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the kernel, all in fp32.

    Returns (o (B, T, D) in q's dtype, lse (B, H, T) fp32, natural log). The
    key mask is a boolean (nonzero = valid); a row with no valid key gives
    o = 0 and lse = -inf."""
    qh, kh, vh = (_split_heads(x, num_heads).float() for x in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        scores = scores.masked_fill(~valid, -math.inf)
    lse = torch.logsumexp(scores, dim=-1)
    # rows with no valid key: exp(-inf - 0) == 0 everywhere, so o == 0
    shift = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(scores - shift[..., None])
    return _merge_heads(p @ vh).to(q.dtype), lse


def _check_kernel_inputs(q, k, v, num_heads, key_mask):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (B, T, D) q and (B, S, D) k/v")
    b, t, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d % num_heads:
        raise ValueError(f"D={d} is not a multiple of num_heads={num_heads}")
    if d // num_heads not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}, "
                         f"not {d // num_heads}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the kernel takes contiguous q/k/v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if key_mask is not None:
        if tuple(key_mask.shape) != (b, k.shape[1]):
            raise ValueError(f"key_mask must be (B, S) = {(b, k.shape[1])}, "
                             f"not {tuple(key_mask.shape)}")
        if key_mask.device != q.device:
            raise ValueError("key_mask lies on another device than q")


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library("flash_attn_fwd",
                                 ["flash_attn_fwd.cu"]).mmd_flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _flash_attention_cuda(q, k, v, num_heads, key_mask):
    global launches
    _check_kernel_inputs(q, k, v, num_heads, key_mask)
    fn = load_kernel()
    b, t, d = q.shape
    s = k.shape[1]
    valid = None
    if key_mask is not None:
        valid = (key_mask != 0).to(torch.uint8).contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, t), dtype=torch.float32, device=q.device)
    if t == 0:
        return o, lse
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr() if valid is not None else None,
            o.data_ptr(), lse.data_ptr(),
            b, t, s, num_heads, d // num_heads, _DTYPE_CODES[q.dtype],
            cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(rc, f"flash_attn_fwd q {tuple(q.shape)}, k "
                                f"{tuple(k.shape)}, {num_heads} heads, "
                                f"{q.dtype}")
    with _launch_lock:
        launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, key_mask: Optional[torch.Tensor] = None):
    """Fused attention forward -> (o (B, T, D), lse (B, H, T) fp32, natural
    log; -inf for a row with no valid key). key_mask: optional (B, S), nonzero
    = valid key.

    CUDA tensors go to the hand-written kernel, which raises on shapes,
    dtypes or layouts it does not take (head dims 32 and 64, float32 or
    bfloat16, contiguous); CPU tensors go to `flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _flash_attention_cuda(q, k, v, num_heads, key_mask)


# ----------------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------------

def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, dropout_rate: float = 0.0,
                         deterministic: bool = True, fused: bool = False,
                         key_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Attention core (no projections), (B,T,D) x (B,S,D) -> (B,T,D).

    key_mask: optional (B, S) {0,1} key-padding mask (the reference's
    attention_mask). fused=True takes `flash_attention`, which applies it as
    a boolean; fused=False adds it as a -1e9 bias to the explicit path.
    Head dims below 32 always take the explicit path, as in the JAX
    package."""
    _no_dropout(dropout_rate, deterministic)
    if fused and q.shape[-1] // num_heads < 32:
        fused = False
    if fused:
        return flash_attention(q, k, v, num_heads, key_mask)[0]
    kb = None
    if key_mask is not None:
        kb = ((1.0 - key_mask.float()) * -1e9)[:, None, None, :]
    return explicit_attention(q, k, v, num_heads, kb)
