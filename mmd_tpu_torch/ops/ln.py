"""(Residual +) LayerNorm for the Swinv2 serving path: a hand-written CUDA
kernel and its plain PyTorch version.

Counterpart of mmd_tpu/ops/ln.py (forward only; its custom VJP waits for
the fine-tuning slice). `fused_layernorm(params, y, eps, shortcut)`
computes (y - mean) * rsqrt(var + eps) * scale + bias (+ shortcut) with
fp32 statistics, adds the shortcut in fp32 and casts once to y's dtype:

  * CUDA tensors go to the kernel (ops/csrc/layernorm.cu), which raises
    on what it does not take; CPU tensors go to `fused_layernorm_plain`;
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
    """The JAX package's routing rule: C a multiple of 128, rows of 8."""
    if len(shape) < 2:
        return False
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return shape[-1] % 128 == 0 and rows % 8 == 0


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


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library("layernorm", ["layernorm.cu"]).mmd_layernorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _layernorm_cuda(params, y, eps, shortcut):
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
    scale = params.weight.detach().float().contiguous()
    bias = params.bias.detach().float().contiguous()
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
    return _layernorm_cuda(params, y, eps, shortcut)
