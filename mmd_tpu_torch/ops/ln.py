"""(Residual +) LayerNorm for the Swinv2 serving path: a hand-written CUDA
kernel, its plain PyTorch version, and the VJP.

Counterpart of mmd_tpu/ops/ln.py and its custom VJPs `_fused_ln` and
`_fused_ln_res`. `fused_layernorm(params, y, eps, shortcut)`
computes (y - mean) * rsqrt(var + eps) * scale + bias (+ shortcut) with
fp32 statistics, adds the shortcut in fp32 and casts once to y's dtype:

  * CUDA tensors go to the kernel (ops/csrc/layernorm.cu), which raises
    on what it does not take, under a torch.autograd.Function whose
    backward is `fused_layernorm_bwd_plain`, the plain PyTorch port of the
    JAX package's `_ln_adjoint` (jnp math there too, no kernel): dy,
    dscale and dbias, with the shortcut's cotangent passed through; CPU
    tensors go to `fused_layernorm_plain`, which autograd differentiates;
  * a geometry `fused_ln_ok` refuses takes `layers.layernorm` (+ the
    shortcut, added after the cast), as the JAX package does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch
from torch import nn

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import cuda_build

# Launches of the LayerNorm kernel in this process; a run resets it to 0 and
# reads it back to show which path its LayerNorms took.
launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 1024


def fused_ln_ok(shape) -> bool:
    """The JAX package's routing rule -- C a multiple of 128, rows of 8 --
    with the kernel's cap of C <= 1024 (the JAX rule has none)."""
    if len(shape) < 2:
        return False
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return shape[-1] % 128 == 0 and shape[-1] <= _MAX_C and rows % 8 == 0


def fused_layernorm_plain(params: nn.LayerNorm, y: torch.Tensor,
                          eps: float = 1e-5,
                          shortcut: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, fp32 throughout."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    out = (yf - mean) * torch.rsqrt(var + eps)
    out = out * params.weight.float() + params.bias.float()
    if shortcut is not None:
        out = out + shortcut.float()
    return out.to(y.dtype)


def fused_layernorm_bwd_plain(weight: torch.Tensor, y: torch.Tensor,
                              eps: float, g: torch.Tensor):
    """The VJP of (y - mean) * rstd * scale + bias in plain PyTorch, fp32
    (mmd_tpu/ops/ln.py::_ln_adjoint): with yhat = (y - mean) * rstd and
    gs = g * scale,

        dy     = (gs - mean_C(gs) - yhat * mean_C(gs * yhat)) * rstd
        dscale = sum over rows of g * yhat,  dbias = sum over rows of g

    -> (dy in y's dtype, dscale, dbias fp32)."""
    yf = y.float()
    mean = yf.mean(-1, keepdim=True)
    var = (yf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    yhat = (yf - mean) * rstd
    gf = g.float()
    rows = tuple(range(y.dim() - 1))
    dscale = (gf * yhat).sum(rows)
    dbias = gf.sum(rows)
    gs = gf * weight.float()
    dy = (gs - gs.mean(-1, keepdim=True)
          - yhat * (gs * yhat).mean(-1, keepdim=True)) * rstd
    return dy.to(y.dtype), dscale, dbias


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library("layernorm", ["layernorm.cu"]).mmd_layernorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layernorm_cuda(weight, bias, y, eps, shortcut):
    global launches
    c = y.shape[-1]
    if c % 128 or c > _MAX_C:
        raise ValueError(f"the kernel takes C a multiple of 128 up to "
                         f"{_MAX_C}, not {c}")
    if y.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("the kernel takes a contiguous y")
    if shortcut is not None and (shortcut.shape != y.shape
                                 or shortcut.dtype != y.dtype
                                 or shortcut.device != y.device
                                 or not shortcut.is_contiguous()):
        raise ValueError("the shortcut must be a contiguous tensor of y's "
                         "shape, dtype and device")
    scale = weight.float().contiguous()
    bias = bias.float().contiguous()
    if scale.device != y.device or scale.shape != (c,):
        raise ValueError("scale and bias must be (C,) on y's device")
    out = torch.empty_like(y)
    cuda_build.check_aligned(y, out, scale, bias,
                             *(() if shortcut is None else (shortcut,)))
    rows = y.numel() // c
    if rows == 0:
        return out
    fn = load_kernel()
    rc = fn(y.data_ptr(), None if shortcut is None else shortcut.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, c, eps,
            _DTYPE_CODES[y.dtype], cuda_build.device_index(y),
            torch.cuda.current_stream(y.device).cuda_stream)
    cuda_build.check_launch(rc, f"layernorm ({rows}, {c}) {y.dtype}")
    with _launch_lock:
        launches += 1
    return out


class _FusedLayerNorm(torch.autograd.Function):
    """The kernel forward; the backward is the plain VJP. The residuals are
    y and the scale, as in _fused_ln_fwd; the shortcut's cotangent is the
    output's (_fused_ln_res_bwd)."""

    @staticmethod
    def forward(ctx, y, weight, bias, shortcut, eps):
        ctx.save_for_backward(y, weight)
        ctx.eps, ctx.has_shortcut = eps, shortcut is not None
        return _layernorm_cuda(weight, bias, y, eps, shortcut)

    @staticmethod
    def backward(ctx, g):
        y, weight = ctx.saved_tensors
        dy, dscale, dbias = fused_layernorm_bwd_plain(weight, y, ctx.eps, g)
        return (dy, dscale.to(weight.dtype), dbias.to(weight.dtype),
                g if ctx.has_shortcut else None, None)


def fused_layernorm(params: nn.LayerNorm, y: torch.Tensor, eps: float = 1e-5,
                    shortcut: Optional[torch.Tensor] = None) -> torch.Tensor:
    """layernorm(y) * scale + bias (+ shortcut) -> y.dtype, y (..., C)."""
    if not fused_ln_ok(y.shape):
        out = L.layernorm(params, y, eps)
        return out if shortcut is None else shortcut + out
    if y.device.type == "cpu":
        return fused_layernorm_plain(params, y, eps, shortcut)
    if y.device.type != "cuda":
        raise ValueError(f"fused_layernorm runs on cuda or cpu, not "
                         f"{y.device.type}")
    return _FusedLayerNorm.apply(y, params.weight, params.bias, shortcut, eps)
