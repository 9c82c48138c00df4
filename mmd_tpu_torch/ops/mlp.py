"""Fused GELU-MLP with dropout: hand-written CUDA forward and backward
kernels, their mask oracle, and the plain PyTorch versions.

Counterpart of mmd_tpu/ops/mlp.py. The fusion model's MLP (reference
src/model/layers.py:5-21: Linear(D, F) -> GELU -> Dropout -> Linear(F, D)
-> Dropout) runs in one kernel when it trains in bf16 with dropout, so the
(N, F) hidden activation and its mask never reach device memory.

  * `fused_mlp_plain` / `fused_mlp_bwd_plain` -- the kernels' functions in
    plain PyTorch, with the TPU kernels' rounding points (_fwd_kernel,
    _bwd_kernel): a in fp32, h rounded to x's dtype after the hidden mask,
    y rounded once; the backward's dW and db in fp32.
  * `mlp_masks_plain` -- the two keep * scale masks (N, F) and (N, D).
  * `fused_mlp_fwd` / `fused_mlp_bwd` / `mlp_masks` -- CUDA tensors go to
    the kernels (ops/csrc/mlp_fwd.cu, mlp_bwd.cu, mlp_masks.cu), which take
    bf16 with D of 128 or 256 and F a multiple of 128 and raise on anything
    else; CPU tensors go to the plain versions.
  * `fused_mlp` -- the layer: (..., D) -> (..., D), differentiable through
    a torch.autograd.Function whose backward is the backward kernel, as
    _fused_mlp_core's custom VJP is.

Masks: the hidden mask is ops/dropout.py's keep_scale of the first seed of
`dropout.split_seed(seed, 2)` over (N, F), the output mask that of the
second over (N, D), at the absolute row-major index. The unfused
`models/layers.mlp` gives its two dropouts the same seeds, so the fused and
the unfused paths draw the same masks, bit for bit. The JAX package draws
its fused masks from the TPU's per-program seeds (seed + program_id), which
nothing off the TPU reproduces; that seeding is not ported (ROADMAP A15).
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Sequence

import torch

from mmd_tpu_torch.ops import cuda_build
from mmd_tpu_torch.ops import dropout as D

# Launches of the forward, backward and mask kernels in this process; a run
# resets them to 0 and reads them back to show which path its MLPs took.
launches = 0
bwd_launches = 0
mask_launches = 0
_launch_lock = threading.Lock()

_C = math.sqrt(2.0 / math.pi)
_K = 0.044715
WIDTHS = (128, 256)          # the D the kernels are built for
_ROWS = 64                    # rows a tile in the backward kernel
_MAX_GROUPS = 16              # row groups of the backward's weight pass
_HEADERS = ["mlp_common.cuh", "philox.cuh"]


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """mmd_tpu/ops/mlp.py::_gelu_tanh."""
    return 0.5 * a * (1.0 + torch.tanh(_C * (a + _K * a * a * a)))


def gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / da, as _bwd_kernel writes it."""
    t = torch.tanh(_C * (a + _K * a * a * a))
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _C * (
        1.0 + 3.0 * _K * a * a)


def mask_seeds(rate: float, seed: Optional[int]
               ) -> Optional[tuple[int, int]]:
    """(hidden, output) mask seeds of a layer seed, or None when there is no
    dropout."""
    if rate <= 0.0:
        return None
    if not rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), not {rate}")
    if seed is None:
        raise ValueError("fused_mlp dropout requires a seed")
    s1, s2 = D.split_seed(int(seed), 2)
    return s1, s2


def mlp_masks_plain(n: int, d: int, f: int,
                    seeds: Optional[Sequence[int]], rate: float,
                    device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(m1 (n, f), m2 (n, d)) fp32 keep * scale; all ones without dropout."""
    if seeds is None:
        return (torch.ones(n, f, device=device),
                torch.ones(n, d, device=device))
    return (D.keep_scale(seeds[0], (n, f), rate, device),
            D.keep_scale(seeds[1], (n, d), rate, device))


def fused_mlp_plain(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor,
                    seeds: Optional[Sequence[int]], rate: float
                    ) -> torch.Tensor:
    """y (N, D) in x2's dtype, as _fwd_kernel computes it: x2 (N, D), w1
    (D, F) and w2 (F, D) in the compute dtype, b1 and b2 fp32."""
    n, d = x2.shape
    m1, m2 = mlp_masks_plain(n, d, w1.shape[1], seeds, rate, x2.device)
    a = x2.float() @ w1.float() + b1.float()
    h = (gelu_tanh(a) * m1).to(x2.dtype)
    y = (h.float() @ w2.float() + b2.float()) * m2
    return y.to(x2.dtype)


def fused_mlp_bwd_plain(x2: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, dy: torch.Tensor,
                        seeds: Optional[Sequence[int]], rate: float):
    """(dx in x2's dtype, dw1, db1, dw2, db2 in fp32), step for step as
    _bwd_kernel computes them from the forward's inputs and dy."""
    n, d = x2.shape
    dtype = x2.dtype
    m1, m2 = mlp_masks_plain(n, d, w1.shape[1], seeds, rate, x2.device)
    x, w1f, w2f = x2.float(), w1.float(), w2.float()
    a = x @ w1f + b1.float()
    h = gelu_tanh(a) * m1
    dyf = dy.float() * m2
    dyb = dyf.to(dtype).float()
    hb = h.to(dtype).float()
    dh = dyb @ w2f.T
    dw2 = hb.T @ dyb
    db2 = dyf.sum(0)
    da = dh * m1 * gelu_tanh_grad(a)
    dab = da.to(dtype).float()
    dx = (dab @ w1f.T).to(dtype)
    dw1 = x.T @ dab
    db1 = da.sum(0)
    return dx, dw1, db1, dw2, db2


# ----------------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------------

_DROP_ARGS = [ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
              ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def load_kernel():
    """Build (at first use) and load the forward kernel's C entry point."""
    fn = cuda_build.load_library("mlp_fwd", ["mlp_fwd.cu"],
                                 _HEADERS).mmd_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int] + _DROP_ARGS
    fn.restype = ctypes.c_int
    return fn


def load_bwd_kernel():
    """Build (at first use) and load the backward kernels' C entry point."""
    fn = cuda_build.load_library("mlp_bwd", ["mlp_bwd.cu"],
                                 _HEADERS).mmd_mlp_bwd
    fn.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64] + _DROP_ARGS
    fn.restype = ctypes.c_int
    return fn


def load_masks_kernel():
    """Build (at first use) and load the mask oracle's C entry point."""
    fn = cuda_build.load_library("mlp_masks", ["mlp_masks.cu"],
                                 _HEADERS).mmd_mlp_masks
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int] + _DROP_ARGS
    fn.restype = ctypes.c_int
    return fn


def _drop_args(seeds, rate: float, t: torch.Tensor) -> list:
    """Mask and launch arguments of the C entry points, for tensor t's
    device."""
    s1, s2 = seeds if seeds is not None else (0, 0)
    return [s1, s2, D.threshold(rate), 1.0 / (1.0 - rate),
            int(seeds is not None), cuda_build.device_index(t),
            torch.cuda.current_stream(t.device).cuda_stream]


def _check_kernel_inputs(x2, w1, b1, w2, b2=None) -> tuple[int, int, int]:
    if x2.dim() != 2:
        raise ValueError(f"x must be (N, D), not {tuple(x2.shape)}")
    n, d = x2.shape
    f = w1.shape[1] if w1.dim() == 2 else -1
    if d not in WIDTHS or f <= 0 or f % 128:
        raise ValueError(f"the fused MLP kernels take D in {WIDTHS} and F a "
                         f"multiple of 128, not D {d}, F {f}")
    want = [("x", x2, (n, d), torch.bfloat16), ("w1", w1, (d, f),
                                                torch.bfloat16),
            ("b1", b1, (f,), torch.float32), ("w2", w2, (f, d),
                                              torch.bfloat16)]
    if b2 is not None:
        want.append(("b2", b2, (d,), torch.float32))
    for name, t, shape, dtype in want:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"the fused MLP kernels take {name} {shape} "
                             f"{dtype}, not {tuple(t.shape)} {t.dtype}")
        if t.device != x2.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on x's device")
    cuda_build.check_aligned(*(t for _, t, _, _ in want))
    return n, d, f


def _mlp_fwd_cuda(x2, w1, b1, w2, b2, seeds, rate):
    global launches
    n, d, f = _check_kernel_inputs(x2, w1, b1, w2, b2)
    y = torch.empty_like(x2)
    if n == 0:
        return y
    fn = load_kernel()
    rc = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(), n, d, f,
            *_drop_args(seeds, rate, x2))
    cuda_build.check_launch(rc, f"mlp_fwd x {tuple(x2.shape)}, F {f}, "
                                f"dropout {rate}")
    with _launch_lock:
        launches += 1
    return y


def backward_groups(n: int) -> tuple[int, int]:
    """(groups, rows a group) of the backward's weight pass: up to 16
    groups of whole 64-row tiles, each summed in a fixed order."""
    tiles = max(1, -(-n // _ROWS))
    per = -(-tiles // min(_MAX_GROUPS, tiles))
    return -(-tiles // per), per * _ROWS


def _mlp_bwd_cuda(x2, w1, b1, w2, dy, seeds, rate):
    global bwd_launches
    n, d, f = _check_kernel_inputs(x2, w1, b1, w2)
    if dy.shape != x2.shape or dy.dtype != x2.dtype \
            or dy.device != x2.device or not dy.is_contiguous():
        raise ValueError("dy must be a contiguous tensor of x's shape, dtype "
                         "and device")
    cuda_build.check_aligned(dy)
    dev = x2.device
    dx = torch.empty_like(x2)
    dw1 = torch.zeros(d, f, device=dev)
    db1 = torch.zeros(f, device=dev)
    dw2 = torch.zeros(f, d, device=dev)
    db2 = torch.zeros(d, device=dev)
    if n == 0:
        return dx, dw1, db1, dw2, db2
    groups, group_rows = backward_groups(n)
    dyb = torch.empty_like(dy)
    ws = torch.empty(groups, 2 * d * f + f + d, device=dev)
    fn = load_bwd_kernel()
    rc = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dyb.data_ptr(), ws.data_ptr(),
            dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            n, d, f, groups, group_rows, *_drop_args(seeds, rate, x2))
    cuda_build.check_launch(rc, f"mlp_bwd x {tuple(x2.shape)}, F {f}, "
                                f"dropout {rate}")
    with _launch_lock:
        bwd_launches += 1
    return dx, dw1, db1, dw2, db2


def fused_mlp_fwd(x2, w1, b1, w2, b2, seeds, rate: float) -> torch.Tensor:
    """The forward: kernel #3 on CUDA tensors, `fused_mlp_plain` on CPU."""
    if cuda_build.on_cuda(x2, "fused_mlp_fwd"):
        return _mlp_fwd_cuda(x2, w1, b1, w2, b2, seeds, rate)
    return fused_mlp_plain(x2, w1, b1, w2, b2, seeds, rate)


def fused_mlp_bwd(x2, w1, b1, w2, dy, seeds, rate: float):
    """The backward: kernel #4 on CUDA tensors, `fused_mlp_bwd_plain` on
    CPU."""
    if cuda_build.on_cuda(x2, "fused_mlp_bwd"):
        return _mlp_bwd_cuda(x2, w1, b1, w2, dy, seeds, rate)
    return fused_mlp_bwd_plain(x2, w1, b1, w2, dy, seeds, rate)


def mlp_masks(n: int, d: int, f: int, seeds, rate: float,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """(m1, m2) of the fused MLP: the oracle kernel (#12) on a CUDA
    device, `mlp_masks_plain` on the CPU."""
    global mask_launches
    device = torch.device(device)
    if device.type == "cpu":
        return mlp_masks_plain(n, d, f, seeds, rate, device)
    if device.type != "cuda":
        raise ValueError(f"mlp_masks runs on cuda or cpu, not {device.type}")
    if n <= 0 or d <= 0 or f <= 0 or d % 8 or f % 8:
        raise ValueError(f"the mask kernel takes N > 0 and D, F multiples of "
                         f"8, not N {n}, D {d}, F {f}")
    m1 = torch.empty(n, f, device=device)
    m2 = torch.empty(n, d, device=device)
    fn = load_masks_kernel()
    rc = fn(m1.data_ptr(), m2.data_ptr(), n, d, f,
            *_drop_args(seeds, rate, m1))
    cuda_build.check_launch(rc, f"mlp_masks N {n}, D {d}, F {f}")
    with _launch_lock:
        mask_launches += 1
    return m1, m2


class _FusedMLP(torch.autograd.Function):
    """Forward kernel, backward kernel: the residuals are the inputs and the
    seeds, as in _fused_mlp_core_fwd. dx comes back in x's dtype, dW1 and
    dW2 rounded once to the weights' dtype, db1 and db2 in the biases'."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2, seeds, rate):
        ctx.save_for_backward(x2, w1, b1, w2, b2)
        ctx.seeds, ctx.rate = seeds, rate
        return fused_mlp_fwd(x2, w1, b1, w2, b2, seeds, rate)

    @staticmethod
    def backward(ctx, g):
        x2, w1, b1, w2, b2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_mlp_bwd(
            x2, w1, b1, w2, g.to(x2.dtype).contiguous(), ctx.seeds, ctx.rate)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None, None)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, rate: float = 0.0,
              seed: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16,
              tp_mesh=None) -> torch.Tensor:
    """(..., D) -> (..., D) through Linear-GELU-Dropout-Linear-Dropout in one
    kernel; w1 (D, F) and w2 (F, D) in the JAX layout. x and the weights are
    cast to `dtype`, the biases to fp32; `seed` gives the masks when
    rate > 0. Tensor parallelism is the multi-device slice and raises."""
    if tp_mesh is not None:
        raise NotImplementedError("fused_mlp under tensor parallelism is not "
                                  "ported yet (ROADMAP A16)")
    seeds = mask_seeds(rate, seed)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(dtype).contiguous()
    y = _FusedMLP.apply(x2, w1.to(dtype).contiguous(),
                        b1.to(torch.float32).contiguous(),
                        w2.to(dtype).contiguous(),
                        b2.to(torch.float32).contiguous(), seeds,
                        float(rate) if seeds is not None else 0.0)
    return y.reshape(shape)
