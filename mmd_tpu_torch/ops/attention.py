"""Multi-head attention: hand-written CUDA flash-attention forward and
backward kernels, and the plain PyTorch paths.

Counterpart of mmd_tpu/ops/attention.py. The caller passes ALREADY-PROJECTED
q (B, T, D) and k/v (B, S, D); this op splits heads, computes
softmax(q k^T / sqrt(dh)) v (non-causal), optionally drops attention
weights, and merges heads back; the caller applies the output projection.

  * `flash_attention` — the forward kernel (ops/csrc/flash_attn_fwd.cu) for
    CUDA tensors, `flash_attention_plain` for CPU tensors. Key-masked rows
    with no valid key give zeros, as the TPU kernel's do.
  * `flash_attention_bwd` — the backward kernel (ops/csrc/flash_attn_bwd.cu)
    for CUDA tensors, `flash_attention_bwd_plain` for CPU tensors: dq, dk
    and dv from (q, k, v, o, lse, do) and the dropout seed.
  * `fused_attention` — the two as a torch.autograd.Function, saving
    (q, k, v, o, lse, seed) as _fused_attention_core_fwd does.
  * `attention_reference` and the additive-mask path of
    `multi_head_attention(fused=False)` — the reference's explicit path: a
    -1e9 key bias, so a row with no valid key becomes a uniform softmax,
    exactly as the JAX jnp fallback behaves. Autograd differentiates it.

Attention dropout (training) multiplies the normalized weights of
(b, h, t, s) by keep * 1 / (1 - rate), keep drawn from ops/dropout.py's
Philox generator at the weight's row-major index in (B, H, T, S). The
kernels, their plain versions and the explicit path all draw the same mask
from one seed, so the fused and explicit paths give the same training step;
the row sum and lse are those of the undropped weights. Softmax statistics
are fp32 whatever the compute dtype.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from mmd_tpu_torch.ops import cuda_build
from mmd_tpu_torch.ops import dropout as D

# Launches of the flash-attention forward and backward kernels in this
# process; a run resets them to 0 and reads them back to show which path its
# attentions took.
launches = 0
bwd_launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _dropout_on(dropout_rate: float, dropout_seed: Optional[int],
                deterministic: bool) -> bool:
    if dropout_rate <= 0.0 or deterministic:
        return False
    if dropout_seed is None:
        raise ValueError("attention dropout needs a seed when "
                         "non-deterministic")
    return True


def _keep_scale(shape, rate: float, seed: int, device) -> torch.Tensor:
    """(B, H, T, S) fp32 multiplier: 1 / (1 - rate) where kept, else 0."""
    return D.keep_scale(seed, tuple(shape), rate, device)


def explicit_attention(q, k, v, num_heads: int,
                       bias: Optional[torch.Tensor] = None,
                       dropout_rate: float = 0.0, dropout_seed: int = 0):
    """The reference's explicit path: fp32 scores from the compute-dtype
    inputs, an optional additive fp32 bias broadcastable to (B, H, T, S),
    fp32 softmax, dropout of the weights when dropout_rate > 0 (the mask of
    seed `dropout_seed`), weights rounded to v's dtype, fp32 accumulation
    of P.V."""
    qh, kh, vh = (_split_heads(x, num_heads) for x in (q, k, v))
    dh = qh.shape[-1]
    scores = (qh.float() @ kh.float().transpose(-1, -2)) / math.sqrt(dh)
    if bias is not None:
        scores = scores + bias
    w = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        w = w * _keep_scale(w.shape, dropout_rate, dropout_seed, w.device)
    ctx = w.to(vh.dtype).float() @ vh.float()
    return _merge_heads(ctx).to(q.dtype)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int, dropout_rate: float = 0.0,
                        dropout_seed: Optional[int] = None,
                        deterministic: bool = True) -> torch.Tensor:
    """Explicit attention over (B, T, D) q and (B, S, D) k/v -> (B, T, D)."""
    rate = dropout_rate if _dropout_on(dropout_rate, dropout_seed,
                                       deterministic) else 0.0
    return explicit_attention(q, k, v, num_heads, dropout_rate=rate,
                              dropout_seed=dropout_seed or 0)


# ----------------------------------------------------------------------------
# The flash-attention forward: kernel and plain version
# ----------------------------------------------------------------------------

def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          num_heads: int,
                          key_mask: Optional[torch.Tensor] = None,
                          dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the kernel, all in fp32.

    Returns (o (B, T, D) in q's dtype, lse (B, H, T) fp32, natural log). The
    key mask is a boolean (nonzero = valid); a row with no valid key gives
    o = 0 and lse = -inf. dropout_rate > 0 drops normalized weights with the
    mask of `seed`; lse is that of the undropped weights."""
    qh, kh, vh = (_split_heads(x, num_heads).float() for x in (q, k, v))
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    if key_mask is not None:
        valid = (key_mask != 0)[:, None, None, :]
        scores = scores.masked_fill(~valid, -math.inf)
    lse = torch.logsumexp(scores, dim=-1)
    # rows with no valid key: exp(-inf - 0) == 0 everywhere, so o == 0
    shift = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse)
    p = torch.exp(scores - shift[..., None])
    if dropout_rate > 0.0:
        p = p * _keep_scale(p.shape, dropout_rate, seed, p.device)
    return _merge_heads(p @ vh).to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, num_heads: int,
                              key_mask: Optional[torch.Tensor] = None,
                              dropout_rate: float = 0.0, seed: int = 0):
    """The backward kernel's formulas in plain PyTorch, all in fp32 (not
    autograd): p = exp(s - lse), 0 for masked keys and rows whose lse is
    -inf; D = rowsum(do * o); dv = (p keep scale)^T do; dp = do v^T;
    ds = p (dp keep scale - D); dq = ds k / sqrt(dh); dk = ds^T q / sqrt(dh).
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    qh, kh, vh, oh, doh = (_split_heads(x, num_heads).float()
                           for x in (q, k, v, o, do))
    sm_scale = 1.0 / math.sqrt(qh.shape[-1])
    scores = (qh @ kh.transpose(-1, -2)) * sm_scale
    live = torch.isfinite(lse)[..., None]
    if key_mask is not None:
        live = live & (key_mask != 0)[:, None, None, :]
    shift = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    p = torch.where(live, torch.exp(scores - shift[..., None]),
                    torch.zeros((), device=q.device))
    ks = (_keep_scale(p.shape, dropout_rate, seed, p.device)
          if dropout_rate > 0.0 else None)
    pd = p if ks is None else p * ks
    delta = (doh * oh).sum(-1, keepdim=True)
    dv = pd.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    if ks is not None:
        dp = dp * ks
    ds = p * (dp - delta)
    dq = (ds @ kh) * sm_scale
    dk = (ds.transpose(-1, -2) @ qh) * sm_scale
    return (_merge_heads(dq).to(q.dtype), _merge_heads(dk).to(k.dtype),
            _merge_heads(dv).to(v.dtype))


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


_DROP_ARGTYPES = [ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float,
                  ctypes.c_int]


def load_kernel():
    """Build (at first use) and load the forward kernel; returns its C entry
    point."""
    fn = cuda_build.load_library("flash_attn_fwd", ["flash_attn_fwd.cu"],
                                 ["philox.cuh"]).mmd_flash_attn_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + _DROP_ARGTYPES + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def load_bwd_kernel():
    """Build (at first use) and load the backward kernels; returns their C
    entry point."""
    fn = cuda_build.load_library("flash_attn_bwd", ["flash_attn_bwd.cu"],
                                 ["philox.cuh"]).mmd_flash_attn_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + _DROP_ARGTYPES + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _dropout_args(dropout_rate: float, seed: int) -> tuple:
    if dropout_rate <= 0.0:
        return 0, 0, 0.0, 0
    if dropout_rate >= 1.0:
        raise ValueError(f"dropout rate must be below 1, not {dropout_rate}")
    return (seed & 0xFFFFFFFFFFFFFFFF, D.threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate), 1)


def _key_valid(key_mask):
    if key_mask is None:
        return None
    return (key_mask != 0).to(torch.uint8).contiguous()


def _flash_attention_cuda(q, k, v, num_heads, key_mask, dropout_rate, seed):
    global launches
    _check_kernel_inputs(q, k, v, num_heads, key_mask)
    drop = _dropout_args(dropout_rate, seed)
    fn = load_kernel()
    b, t, d = q.shape
    s = k.shape[1]
    valid = _key_valid(key_mask)
    o = torch.empty_like(q)
    lse = torch.empty((b, num_heads, t), dtype=torch.float32, device=q.device)
    if t == 0:
        return o, lse
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr() if valid is not None else None,
            o.data_ptr(), lse.data_ptr(),
            b, t, s, num_heads, d // num_heads, _DTYPE_CODES[q.dtype], *drop,
            cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(rc, f"flash_attn_fwd q {tuple(q.shape)}, k "
                                f"{tuple(k.shape)}, {num_heads} heads, "
                                f"{q.dtype}, dropout {dropout_rate}")
    with _launch_lock:
        launches += 1
    return o, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, key_mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, seed: int = 0):
    """Fused attention forward -> (o (B, T, D), lse (B, H, T) fp32, natural
    log; -inf for a row with no valid key). key_mask: optional (B, S), nonzero
    = valid key. dropout_rate > 0 drops attention weights with the mask of
    `seed` (lse does not depend on it).

    CUDA tensors go to the hand-written kernel, which raises on shapes,
    dtypes or layouts it does not take (head dims 32 and 64, float32 or
    bfloat16, contiguous); CPU tensors go to `flash_attention_plain`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads, key_mask,
                                     dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _flash_attention_cuda(q, k, v, num_heads, key_mask, dropout_rate,
                                 seed)


def _flash_attention_bwd_cuda(q, k, v, o, lse, do, num_heads, key_mask,
                              dropout_rate, seed):
    global bwd_launches
    _check_kernel_inputs(q, k, v, num_heads, key_mask)
    b, t, d = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of q's "
                             f"shape, dtype and device")
    if (lse.shape != (b, num_heads, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous (B, H, T) = "
                         f"{(b, num_heads, t)} float32 on q's device")
    drop = _dropout_args(dropout_rate, seed)
    s = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if t == 0 or s == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    fn = load_bwd_kernel()
    valid = _key_valid(key_mask)
    delta = torch.empty((b, num_heads, t), dtype=torch.float32,
                        device=q.device)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr() if valid is not None else None,
            o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, t, s, num_heads, d // num_heads, _DTYPE_CODES[q.dtype], *drop,
            cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check_launch(rc, f"flash_attn_bwd q {tuple(q.shape)}, k "
                                f"{tuple(k.shape)}, {num_heads} heads, "
                                f"{q.dtype}, dropout {dropout_rate}")
    with _launch_lock:
        bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, num_heads: int,
                        key_mask: Optional[torch.Tensor] = None,
                        dropout_rate: float = 0.0, seed: int = 0):
    """Fused attention backward -> (dq, dk, dv) in the inputs' dtype, from
    the forward's (o, lse) and the output gradient do; the dropout mask is
    regenerated from `seed`.

    CUDA tensors go to the hand-written kernels, which raise on what they
    do not take; CPU tensors go to `flash_attention_bwd_plain`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, num_heads,
                                         key_mask, dropout_rate, seed)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _flash_attention_bwd_cuda(q, k, v, o, lse, do, num_heads,
                                     key_mask, dropout_rate, seed)


class _FusedAttention(torch.autograd.Function):
    """Forward kernel, backward kernel: the residuals are (q, k, v, o, lse)
    and the seed, as in _fused_attention_core_fwd."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, num_heads, dropout_rate, seed):
        o, lse = flash_attention(q, k, v, num_heads, key_mask, dropout_rate,
                                 seed)
        ctx.save_for_backward(q, k, v, o, lse, key_mask)
        ctx.num_heads, ctx.dropout_rate, ctx.seed = (num_heads, dropout_rate,
                                                     seed)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do.to(q.dtype).contiguous(), ctx.num_heads,
            key_mask, ctx.dropout_rate, ctx.seed)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    num_heads: int, key_mask: Optional[torch.Tensor] = None,
                    dropout_rate: float = 0.0, seed: int = 0) -> torch.Tensor:
    """`flash_attention`'s o, differentiable through `flash_attention_bwd`."""
    return _FusedAttention.apply(q, k, v, key_mask, num_heads, dropout_rate,
                                 int(seed))


# ----------------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------------

def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, dropout_rate: float = 0.0,
                         dropout_seed: Optional[int] = None,
                         deterministic: bool = True, fused: bool = False,
                         key_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Attention core (no projections), (B,T,D) x (B,S,D) -> (B,T,D).

    key_mask: optional (B, S) {0,1} key-padding mask (the reference's
    attention_mask). fused=True takes `fused_attention` (the kernels on
    CUDA tensors), which applies it as a boolean; fused=False adds it as a
    -1e9 bias to the explicit path. Dropout of the attention weights runs
    when dropout_rate > 0 and not deterministic, on either path, with the
    mask of `dropout_seed`. Head dims below 32 always take the explicit
    path, as in the JAX package."""
    rate = dropout_rate if _dropout_on(dropout_rate, dropout_seed,
                                       deterministic) else 0.0
    seed = dropout_seed if rate > 0.0 else 0
    if fused and q.shape[-1] // num_heads < 32:
        fused = False
    if fused:
        return fused_attention(q, k, v, num_heads, key_mask, rate, seed)
    kb = None
    if key_mask is not None:
        kb = ((1.0 - key_mask.float()) * -1e9)[:, None, None, :]
    return explicit_attention(q, k, v, num_heads, kb, rate, seed)
