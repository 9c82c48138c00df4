"""Fused GELU-MLP with dropout: hand-written CUDA forward and backward
kernels, their mask oracle, and the plain PyTorch versions.

Counterpart of mmd_tpu/ops/mlp.py. The fusion model's MLP (reference
src/model/layers.py:5-21: Linear(D, F) -> GELU -> Dropout -> Linear(F, D)
-> Dropout) runs in one kernel when it trains in bf16 with dropout, so the
forward's (N, F) hidden activation and its mask never reach device memory;
the backward (three launches) writes the rounded hidden activation and its
gradient to a workspace once and reads them back once, for the weight
gradients.

  * `fused_mlp_plain` / `fused_mlp_bwd_plain` -- the kernels' functions in
    plain PyTorch, with the TPU kernels' rounding points (_fwd_kernel,
    _bwd_kernel): a in fp32, h rounded to x's dtype after the hidden mask,
    y rounded once; the backward's dW and db in fp32.
  * `mlp_masks_plain` -- the two keep * scale masks (N, F) and (N, D).
  * `fused_mlp_fwd` / `fused_mlp_bwd` / `mlp_masks` -- CUDA tensors go to
    the kernels (ops/csrc/mlp_fwd.cu, mlp_bwd.cu, mlp_masks.cu), which take
    bf16 with D and F multiples of 128, D up to MAX_WIDTH, and raise on
    anything else; CPU tensors go to the plain versions. D 128 and 256 run
    the one-kernel forward; a wider D runs it as two launches through an
    (N, F) workspace (mlp_fwd.cu), and the backward's first pass streams x
    and dy along D (mlp_bwd.cu).
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
MAX_WIDTH = 1024             # the widest D the kernels take (mlp_common.cuh MAX_D)
_ROWS = 64                    # a row group of the backward holds whole 64s
_MAX_GROUPS = 16              # row groups of the backward's weight products
_HEADERS = ["mlp_common.cuh", "mlp_tile.cuh", "philox.cuh",
            "tensor_core.cuh", "wgmma.cuh"]


def gelu_tanh(a: torch.Tensor) -> torch.Tensor:
    """mmd_tpu/ops/mlp.py::_gelu_tanh."""
    return 0.5 * a * (1.0 + torch.tanh(_C * (a + _K * a * a * a)))


def gelu_tanh_grad(a: torch.Tensor) -> torch.Tensor:
    """d gelu_tanh / da, as _bwd_kernel writes it."""
    t = torch.tanh(_C * (a + _K * a * a * a))
    return 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * _C * (
        1.0 + 3.0 * _K * a * a)


def mask_seeds(rate: float, seed) -> Optional[tuple[int, int]]:
    """(hidden, output) mask seeds of a layer seed, or None when there is no
    dropout; a pair of seeds is taken as already split."""
    if rate <= 0.0:
        return None
    if not rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), not {rate}")
    if seed is None:
        raise ValueError("fused_mlp dropout requires a seed")
    if isinstance(seed, tuple):
        return tuple(int(s) for s in seed)
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
# The C entry points: name -> (library, argtypes, restype); each bound once,
# its argtypes set at load.
_ENTRIES = {
    "mmd_mlp_fwd": ("mlp_fwd", [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        + _DROP_ARGS, ctypes.c_int),
    "mmd_mlp_fwd_workspace": ("mlp_fwd", [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int], ctypes.c_int64),
    "mmd_mlp_bwd": ("mlp_bwd", [ctypes.c_void_p] * 8 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64] + _DROP_ARGS, ctypes.c_int),
    "mmd_mlp_bwd_workspace": ("mlp_bwd", [ctypes.c_int64, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int],
                              ctypes.c_int64),
    "mmd_mlp_masks": ("mlp_masks", [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int] + _DROP_ARGS,
        ctypes.c_int)}
_fns: dict[str, ctypes._CFuncPtr] = {}


def _entry(name: str) -> ctypes._CFuncPtr:
    fn = _fns.get(name)
    if fn is None:
        library, argtypes, restype = _ENTRIES[name]
        fn = getattr(cuda_build.load_library(library, [f"{library}.cu"],
                                             _HEADERS), name)
        fn.argtypes, fn.restype = argtypes, restype
        _fns[name] = fn
    return fn


def load_kernel():
    """Build (at first use) and load the forward kernel's C entry point."""
    return _entry("mmd_mlp_fwd")


def load_bwd_kernel():
    """Build (at first use) and load the backward kernels' C entry point."""
    return _entry("mmd_mlp_bwd")


def load_masks_kernel():
    """Build (at first use) and load the mask oracle's C entry point."""
    return _entry("mmd_mlp_masks")


def _drop_args(seeds, rate: float, t: torch.Tensor) -> list:
    """Mask and launch arguments of the C entry points, for tensor t's
    device."""
    s1, s2 = seeds if seeds is not None else (0, 0)
    return [s1, s2, D.threshold(rate), 1.0 / (1.0 - rate),
            int(seeds is not None), cuda_build.device_index(t),
            torch.cuda.current_stream(t.device).cuda_stream]


def kernel_widths_ok(d: int, f: int) -> bool:
    """Whether the kernels take widths D and F: both multiples of 128, D
    up to MAX_WIDTH."""
    return 0 < d <= MAX_WIDTH and d % 128 == 0 and f > 0 and f % 128 == 0


def _check_kernel_inputs(x2, w1, b1, w2, b2=None) -> tuple[int, int, int]:
    if x2.dim() != 2:
        raise ValueError(f"x must be (N, D), not {tuple(x2.shape)}")
    n, d = x2.shape
    f = w1.shape[1] if w1.dim() == 2 else -1
    if not kernel_widths_ok(d, f):
        raise ValueError(f"the fused MLP kernels take D and F multiples of "
                         f"128, D up to {MAX_WIDTH}, not D {d}, F {f}")
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
    nbytes = _entry("mmd_mlp_fwd_workspace")(n, d, f)
    # the two-launch path's (N, F) bf16 h (D above 256); none otherwise
    ws = torch.empty(nbytes, dtype=torch.uint8, device=x2.device) \
        if nbytes else None
    s1, s2 = seeds if seeds is not None else (0, 0)
    idx = x2.get_device()
    rc = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), y.data_ptr(),
            ws.data_ptr() if ws is not None else None, nbytes, n, d, f, s1,
            s2, D.threshold(rate), 1.0 / (1.0 - rate), int(seeds is not None),
            idx, torch._C._cuda_getCurrentRawStream(idx))
    if rc:
        cuda_build.check_launch(rc, f"mlp_fwd x {tuple(x2.shape)}, F {f}, "
                                    f"dropout {rate}")
    with _launch_lock:
        launches += 1
    return y


def backward_groups(n: int) -> tuple[int, int]:
    """(groups, rows a group) of the backward's weight products, split over
    their contraction (the rows): up to 16 groups of whole 64-row tiles,
    each summed in a fixed order."""
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
    # [dW1 | dW2 | db1 | db2], which the kernels write whole
    grads = torch.empty(2 * d * f + f + d, device=dev)
    dw1, dw2 = grads[:d * f].view(d, f), grads[d * f:2 * d * f].view(f, d)
    db1, db2 = grads[2 * d * f:2 * d * f + f], grads[2 * d * f + f:]
    if n == 0:
        grads.zero_()
        return dx, dw1, db1, dw2, db2
    groups, group_rows = backward_groups(n)
    fn = load_bwd_kernel()
    nbytes = _entry("mmd_mlp_bwd_workspace")(n, d, f, groups)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    s1, s2 = seeds if seeds is not None else (0, 0)
    idx = x2.get_device()
    rc = fn(x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), grads.data_ptr(), ws.data_ptr(),
            nbytes, n, d, f, groups, group_rows, s1, s2, D.threshold(rate),
            1.0 / (1.0 - rate), int(seeds is not None), idx,
            torch._C._cuda_getCurrentRawStream(idx))
    if rc:
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
              seed=None, dtype: torch.dtype = torch.bfloat16,
              tp_mesh=None) -> torch.Tensor:
    """(..., D) -> (..., D) through Linear-GELU-Dropout-Linear-Dropout in one
    kernel; w1 (D, F) and w2 (F, D) in the JAX layout. x and the weights are
    cast to `dtype`, the biases to fp32. When rate > 0, `seed` gives the
    masks: a layer seed (split by `mask_seeds`), or the (hidden, output)
    mask seeds already split (and, under a mesh, folded by
    parallel/tp.FusionParallel.split).

    With `tp_mesh`, the rank's block of a Megatron split (the JAX
    package's shard_map, mmd_tpu/ops/mlp.py:234-292): x is the rank's rows,
    w1 (D, F/tp) and b1 (F/tp,) its columns, w2 (F/tp, D) its rows, b2
    whole. The kernel computes the rank's full-D partial with b2/tp added,
    and the partials are summed over the model axis in fp32. The seeds
    must then be the folded pair: the hidden mask's folded by the data and
    model indices (each rank's F/tp slice draws its own mask), the output
    mask's by the data index alone, so every model rank draws the same
    output mask, mask * sum(partials) == sum(mask * partials), and the sum
    is the unsplit layer's output. x and b2 enter through `copy_to_axis`,
    so their gradients are summed over the model axis as well."""
    if tp_mesh is not None and rate > 0.0 and not isinstance(seed, tuple):
        raise ValueError("fused_mlp under tp_mesh takes the (hidden, output) "
                         "mask seeds parallel/tp.FusionParallel.split "
                         "folded, not a layer seed")
    seeds = mask_seeds(rate, seed)
    if tp_mesh is not None:
        from mmd_tpu_torch.core.mesh import MODEL_AXIS
        from mmd_tpu_torch.parallel import collectives as C
        tp = tp_mesh.shape[MODEL_AXIS]
        x = C.copy_to_axis(x, tp_mesh, MODEL_AXIS)
        b2 = C.copy_to_axis(b2.float(), tp_mesh, MODEL_AXIS) * (1.0 / tp)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(dtype).contiguous()
    y = _FusedMLP.apply(x2, w1.to(dtype).contiguous(),
                        b1.to(torch.float32).contiguous(),
                        w2.to(dtype).contiguous(),
                        b2.to(torch.float32).contiguous(), seeds,
                        float(rate) if seeds is not None else 0.0)
    if tp_mesh is not None:
        y = C.reduce_from_axis(y.float(), tp_mesh, MODEL_AXIS).to(y.dtype)
    return y.reshape(shape)
