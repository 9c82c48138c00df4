"""Swinv2 window attention: hand-written CUDA kernels for serving and for
fine-tuning, and their plain PyTorch versions.

Serving: the counterpart of mmd_tpu/ops/swin_attention.py's
`swin_window_attention_infer`. The caller passes the RAW post-projection
q, k, v in the window-major layout (nW, B, n, C), so that the blocks of one
window share its bias; per window, batch row and head the op computes

    s = (q/|q| . k/|k|) * scale[h] + bias[w, h]      (natural log)
    o = softmax(s) . v

with fp32 norms, scores and softmax. `scale` is the clamped logit scale
exp(min(logit_scale, ln 100)), shape (heads,); `bias` is fp32
(nW or 1, heads, n, n): the continuous position bias plus twice the
shifted-window mask, or the position bias alone for every window. (The
JAX package takes both in the log2 domain and packs them for Mosaic; its
bf16 kernel also rounds the squares before the norms.)

  * CUDA tensors go to the kernel (ops/csrc/swin_window_attn.cu over the
    forward body it shares with the fine-tuning forward, swin_fwd.cuh): n
    = 64, head dims 32 and 64, float32 or bfloat16, the batch split into
    the groups of `batch_groups`; in bf16 it rounds the unnormalized P to
    bf16 before P.V, as the JAX kernel does. It raises on the rest, and on
    inputs that require grad while grad is enabled, since it has no
    backward (neither has the JAX package's serving kernel).
  * CPU tensors go to `swin_window_attention_infer_plain`.

Fine-tuning: `swin_window_attention`, the counterpart of the JAX package's
custom VJP of the same name (forward `_call_fwd`, backward
`_swin_attn_bwd`), a torch.autograd.Function. q' arrives L2-normalized per
head and pre-scaled by the clamped logit scale times log2(e), k
L2-normalized (the caller normalizes, and autograd differentiates that);
bias is fp32 (nW, heads, n, n) in the log2 domain. Per window, batch row
and head:

    o = softmax2(q' . k + bias) . v       (exp2, sums floored at 1e-37)

and the backward returns dq', dk, dv and dbias (summed over the batch,
the gradient of the continuous position bias MLP):

  * CUDA tensors go to the kernels (ops/csrc/swin_window_attn_train.cu):
    n = 64, head dims 32 and 64, float32 or bfloat16; in bf16 the forward
    rounds the unnormalized P to bf16 before P.V, as the JAX kernel does,
    and the backward keeps P and dS to ~2^-17 (bf16 hi + lo) in its
    products, as the JAX kernel keeps them in fp32;
  * CPU tensors go to `swin_window_attention_plain` and
    `swin_window_attention_bwd_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the serving kernel (#7) and of the fine-tuning forward (#8)
# and backward (#9) in this process; a run resets them to 0 and reads them
# back to show which path its window attentions took.
launches = 0
train_launches = 0
train_bwd_launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64)
_TOKENS = 64


def _group_size(dh: int, heads: int) -> int:
    """Heads per packed group in the JAX package's kernel."""
    g = 128 // dh if (dh < 128 and 128 % dh == 0) else 1
    while g > 1 and heads % g != 0:
        g //= 2
    return g


def fused_ok(window: int, dh: int, heads: int) -> bool:
    """Which blocks take the fused kernels: the JAX package's rule
    (models/swin.py::_fused_ok), narrowed to what kernels #7, #8 and #9
    take -- windows of 64 tokens and head dims 32 or 64. Another window
    (16 x 16, say, which the JAX rule admits) takes the explicit path."""
    n = window * window
    return (n == _TOKENS and dh in _HEAD_DIMS
            and (_group_size(dh, heads) * n) % 128 == 0)


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    nw, b, n, c = x.shape
    return x.reshape(nw, b, n, heads, c // heads).transpose(2, 3)


def swin_window_attention_infer_plain(q, k, v, bias, scale, heads: int
                                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 throughout.

    q, k, v (nW, B, n, C); bias (nW or 1, heads, n, n) fp32; scale (heads,)
    fp32 -> (nW, B, n, C) in q's dtype."""
    qh, kh, vh = (_split(x, heads).float() for x in (q, k, v))
    qh = qh / qh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kh = kh / kh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    s = (qh @ kh.transpose(-1, -2)) * scale.float()[:, None, None]
    s = s + bias.float()[:, None]                 # (nW, 1, h, n, n)
    p = torch.softmax(s, dim=-1)
    o = p @ vh                                    # (nW, B, h, n, dh)
    nw, b, n, c = q.shape
    return o.transpose(2, 3).reshape(nw, b, n, c).to(q.dtype)


# The C entry points of the serving library (#7) and of the fine-tuning
# library (#8, #9): name -> (library, argtypes); each bound once, its
# argtypes set at load.
_ENTRIES = {
    "mmd_swin_window_attn_fwd": ("swin_window_attn", [ctypes.c_void_p] * 6
                                 + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    "mmd_swin_attn_train_fwd": ("swin_window_attn_train",
                                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p]),
    "mmd_swin_attn_train_bwd": ("swin_window_attn_train",
                                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                                + [ctypes.c_void_p])}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _entry(name: str):
    fn = _fns.get(name)
    if fn is None:
        library, argtypes = _ENTRIES[name]
        fn = getattr(cuda_build.load_library(
            library, [f"{library}.cu"],
            headers=["swin_fwd.cuh", "flash_common.cuh", "tensor_core.cuh"]),
            name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    return _entry("mmd_swin_window_attn_fwd")


def _check_kernel_inputs(q, k, v, bias, scale, heads):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (nW, B, n, C) of one shape, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    nw, b, n, c = q.shape
    if n != _TOKENS:
        raise ValueError(f"the kernel takes windows of {_TOKENS} tokens, "
                         f"not {n}")
    if c % heads or c // heads not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}; C={c} "
                         f"over {heads} heads")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q/k/v of one "
                         f"dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if bias.dtype != torch.float32 or bias.dim() != 4 or \
            bias.shape[0] not in (1, nw) or bias.shape[1:] != (heads, n, n):
        raise ValueError(f"bias must be float32 (1 or {nw}, {heads}, {n}, "
                         f"{n}), not {bias.dtype} {tuple(bias.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (heads,):
        raise ValueError(f"scale must be float32 ({heads},)")
    tensors = (q, k, v, bias, scale)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v, bias and scale lie on different devices")


def _swin_attention_cuda(q, k, v, bias, scale, heads):
    global launches
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, bias, scale)):
        raise RuntimeError(
            "swin_window_attention_infer has no backward: under autograd "
            "use swin_window_attention (SwinConfig.fused_train) or the "
            "explicit path (fused_attn=False)")
    _check_kernel_inputs(q, k, v, bias, scale, heads)
    nw, b, n, c = q.shape
    o = torch.empty_like(q)
    cuda_build.check_aligned(q, k, v, bias, o)
    fn = load_kernel()
    dev = q.get_device()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), o.data_ptr(), nw, b, n, heads, c // heads,
            bias.shape[0], batch_groups(nw, b, heads), _DTYPE_CODES[q.dtype],
            dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        cuda_build.check_launch(rc, f"swin_window_attn {tuple(q.shape)} "
                                    f"{heads} heads {q.dtype}")
    with _launch_lock:
        launches += 1
    return o


def swin_window_attention_infer(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, bias: torch.Tensor,
                                scale: torch.Tensor, heads: int
                                ) -> torch.Tensor:
    """Cosine window attention on raw window-major q/k/v (see the module
    docstring) -> (nW, B, n, C). Forward only."""
    if q.device.type == "cpu":
        return swin_window_attention_infer_plain(q, k, v, bias, scale, heads)
    if q.device.type != "cuda":
        raise ValueError(f"swin_window_attention_infer runs on cuda or cpu, "
                         f"not {q.device.type}")
    return _swin_attention_cuda(q, k, v, bias, scale, heads)


# -- fine-tuning: pre-normalized q'/k, log2-domain bias, with a backward -------

_LN2 = 0.6931471805599453
# CTAs (heads x windows x batch groups) to aim for: two an SM of the H100
# in the forward, one an SM in the backward
_CTAS = 2 * 132
_BWD_CTAS = 132


def _softmax2(qh, kh, bias):
    """P of the fine-tuning kernels: (nW, B, h, n, n) fp32."""
    s = qh @ kh.transpose(-1, -2) + bias.float()[:, None]
    p = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-37)


def _merge(x: torch.Tensor) -> torch.Tensor:
    nw, b, h, n, dh = x.shape
    return x.transpose(2, 3).reshape(nw, b, n, h * dh)


def swin_window_attention_plain(q, k, v, bias, heads: int) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, fp32 throughout.
    q, k, v (nW, B, n, C); bias (nW, heads, n, n) fp32 -> (nW, B, n, C) in
    q's dtype."""
    qh, kh, vh = (_split(x, heads).float() for x in (q, k, v))
    return _merge(_softmax2(qh, kh, bias) @ vh).to(q.dtype)


def swin_window_attention_bwd_plain(q, k, v, bias, do, heads: int):
    """The backward kernel's function in plain PyTorch, fp32 throughout
    (`_bwd_kernel`: ds = ln2 P (dP - rowsum(dP P))) -> dq, dk, dv in q's
    dtype and dbias (nW, heads, n, n) fp32, the sum of ds over the
    batch."""
    qh, kh, vh, doh = (_split(x, heads).float() for x in (q, k, v, do))
    p = _softmax2(qh, kh, bias)
    dv = p.transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = _LN2 * p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return (*(_merge(x).to(q.dtype) for x in (dq, dk, dv)), ds.sum(dim=1))


def load_train_kernel():
    """Build (at first use) and load the fine-tuning kernels; returns the
    forward's C entry point."""
    return _entry("mmd_swin_attn_train_fwd")


def load_train_bwd_kernel():
    """The fine-tuning backward's C entry point (same library as
    `load_train_kernel`)."""
    return _entry("mmd_swin_attn_train_bwd")


@functools.lru_cache(maxsize=256)
def batch_groups(windows: int, batch: int, heads: int) -> int:
    """Batch groups of the forwards, serving (#7) and fine-tuning (#8):
    their CTAs are (head, window, group), each walking batch / groups rows. The fewest groups (a divisor
    of the batch) that give `_CTAS` CTAs, or one group per batch row."""
    return _fewest_groups(windows * heads, batch, _CTAS)


@functools.lru_cache(maxsize=256)
def bwd_batch_groups(windows: int, batch: int, heads: int) -> int:
    """Batch groups of the fine-tuning backward, whose CTAs are (head,
    window, group) too. One group (every batch row of a (window, head) in
    one CTA, dbias written by it, one launch) unless that leaves the card
    short of `_BWD_CTAS` CTAs; then the fewest groups that give them, each
    writing its part of dbias to a workspace that a second launch sums."""
    return _fewest_groups(windows * heads, batch, _BWD_CTAS)


def _fewest_groups(pairs: int, batch: int, ctas: int) -> int:
    for g in range(1, batch + 1):
        if batch % g == 0 and pairs * g >= ctas:
            return g
    return batch


def _check_train_inputs(q, k, v, bias, heads, do=None):
    """Raise ValueError on what the fine-tuning kernels do not take. On the
    forward's per-call path: each attribute is read once."""
    shape = q.shape
    if len(shape) != 4 or k.shape != shape or v.shape != shape:
        raise ValueError(f"q, k, v must be (nW, B, n, C) of one shape, not "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    nw, b, n, c = shape
    if n != _TOKENS:
        raise ValueError(f"the kernel takes windows of {_TOKENS} tokens, "
                         f"not {n}")
    dh, rem = divmod(c, heads)
    if rem or dh not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_HEAD_DIMS}; C={c} "
                         f"over {heads} heads")
    dtype = q.dtype
    if dtype not in _DTYPE_CODES or k.dtype != dtype or v.dtype != dtype \
            or (do is not None and do.dtype != dtype):
        tensors = (q, k, v) if do is None else (q, k, v, do)
        raise ValueError(f"the kernel takes float32 or bfloat16 tensors of "
                         f"one dtype, not {[t.dtype for t in tensors]}")
    if do is not None and do.shape != shape:
        raise ValueError("do must have q's shape")
    if bias.dtype != torch.float32 or bias.shape != (nw, heads, n, n):
        raise ValueError(f"bias must be float32 ({nw}, {heads}, {n}, {n}), "
                         f"not {bias.dtype} {tuple(bias.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and bias.is_contiguous()
            and (do is None or do.is_contiguous())):
        raise ValueError("the kernel takes contiguous tensors")
    dev = q.device
    if k.device != dev or v.device != dev or bias.device != dev or (
            do is not None and do.device != dev):
        raise ValueError("the inputs lie on different devices")


def _swin_train_fwd_cuda(q, k, v, bias, heads):
    global train_launches
    _check_train_inputs(q, k, v, bias, heads)
    nw, b, n, c = q.shape
    o = torch.empty_like(q)
    cuda_build.check_aligned(q, k, v, bias, o)
    fn = load_train_kernel()
    dev = q.get_device()
    # the handle torch.cuda.current_stream(dev).cuda_stream gives, without
    # building a Stream object on every call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), nw, b, n, heads, c // heads,
            batch_groups(nw, b, heads), _DTYPE_CODES[q.dtype], dev, stream)
    if rc:
        cuda_build.check_launch(rc, f"swin_attn_train_fwd {tuple(q.shape)} "
                                    f"{heads} heads {q.dtype}")
    with _launch_lock:
        train_launches += 1
    return o


def _swin_train_bwd_cuda(q, k, v, bias, do, heads):
    global train_bwd_launches
    _check_train_inputs(q, k, v, bias, heads, do)
    nw, b, n, c = q.shape
    groups = bwd_batch_groups(nw, b, heads)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = torch.empty_like(bias)
    # the groups' parts of dbias, for the second launch to sum
    ws = torch.empty((groups, *bias.shape), dtype=torch.float32,
                     device=q.device) if groups > 1 else None
    cuda_build.check_aligned(q, k, v, bias, do, dq, dk, dv, dbias)
    fn = load_train_bwd_kernel()
    dev = q.get_device()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dbias.data_ptr(), None if ws is None else ws.data_ptr(),
            nw, b, n, heads, c // heads, groups, _DTYPE_CODES[q.dtype], dev,
            torch._C._cuda_getCurrentRawStream(dev))
    if rc:
        cuda_build.check_launch(rc, f"swin_attn_train_bwd {tuple(q.shape)} "
                                    f"{heads} heads {q.dtype}")
    with _launch_lock:
        train_bwd_launches += 1
    return dq, dk, dv, dbias


def swin_window_attention_fwd(q, k, v, bias, heads: int) -> torch.Tensor:
    """The fine-tuning forward without autograd: the kernel (#8) on CUDA
    tensors, the plain version on CPU ones."""
    if cuda_build.on_cuda(q, "swin_window_attention"):
        return _swin_train_fwd_cuda(q, k, v, bias, heads)
    return swin_window_attention_plain(q, k, v, bias, heads)


def swin_window_attention_bwd(q, k, v, bias, do, heads: int):
    """The fine-tuning backward -> (dq, dk, dv, dbias): the kernel (#9) on
    CUDA tensors, `swin_window_attention_bwd_plain` on CPU ones."""
    if cuda_build.on_cuda(q, "swin_window_attention_bwd"):
        return _swin_train_bwd_cuda(q, k, v, bias, do, heads)
    return swin_window_attention_bwd_plain(q, k, v, bias, do, heads)


class _SwinWindowAttention(torch.autograd.Function):
    """Forward kernel, backward kernel; the residuals are the operands, as
    in the JAX package's _swin_attn_fwd."""

    @staticmethod
    def forward(ctx, q, k, v, bias, heads):
        ctx.save_for_backward(q, k, v, bias)
        ctx.heads = heads
        return swin_window_attention_fwd(q, k, v, bias, heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = swin_window_attention_bwd(
            q, k, v, bias, g.to(q.dtype).contiguous(), ctx.heads)
        return dq, dk, dv, dbias.to(bias.dtype), None


def swin_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor, heads: int) -> torch.Tensor:
    """Window attention on pre-normalized, pre-scaled q' and k with a
    log2-domain bias (see the module docstring) -> (nW, B, n, C),
    differentiable in q', k, v and bias."""
    return _SwinWindowAttention.apply(q, k, v, bias, heads)
