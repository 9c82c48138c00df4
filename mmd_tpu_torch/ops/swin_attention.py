"""Swinv2 cosine window attention for the serving path: a hand-written CUDA
kernel and its plain PyTorch version.

Counterpart of mmd_tpu/ops/swin_attention.py's serving variant
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

  * CUDA tensors go to the kernel (ops/csrc/swin_window_attn.cu): n = 64,
    head dims 32 and 64, float32 or bfloat16; it raises on the rest.
  * CPU tensors go to `swin_window_attention_infer_plain`.

The fine-tuning variant with its backward arrives with the fine-tune slice.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the window-attention kernel in this process; a run resets it
# to 0 and reads it back to show which path its window attentions took.
launches = 0
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
    """The JAX package's rule for which blocks take the fused kernel
    (models/swin.py::_fused_ok), kept so that both packages route the same
    blocks to it."""
    n = window * window
    g = _group_size(dh, heads)
    return dh >= 32 and 128 % dh == 0 and n % 8 == 0 and (g * n) % 128 == 0


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


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library(
        "swin_window_attn", ["swin_window_attn.cu"]).mmd_swin_window_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    _check_kernel_inputs(q, k, v, bias, scale, heads)
    nw, b, n, c = q.shape
    o = torch.empty_like(q)
    cuda_build.check_aligned(q, k, v, bias, o)
    fn = load_kernel()
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            scale.data_ptr(), o.data_ptr(), nw, b, n, heads, c // heads,
            bias.shape[0], _DTYPE_CODES[q.dtype], cuda_build.device_index(q),
            torch.cuda.current_stream(q.device).cuda_stream)
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


def swin_window_attention(*args, **kwargs):
    """The fine-tuning variant (pre-normalized q/k, with a backward)."""
    raise NotImplementedError(
        "swin_window_attention (fine-tuning, with its backward) arrives with "
        "the fine-tune slice")
