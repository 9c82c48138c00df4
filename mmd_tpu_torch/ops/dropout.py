"""Inverted dropout with a counter-based mask: a hand-written CUDA kernel,
its plain PyTorch version, and the generator both share.

Counterpart of mmd_tpu/ops/dropout.py. The mask is a pure function of a
64-bit seed and the absolute element index, drawn from Philox4x32-10
(ops/csrc/philox.cuh): element i keeps its value when lane i & 3 of
philox4x32(counter = i >> 2, key = seed) is below
min(int((1 - rate) * 2^32), 2^32 - 1), the TPU kernels' threshold, and is
then scaled by 1 / (1 - rate). A backward regenerates the forward's mask
from the seed alone, so no mask ever lives in device memory, and tilings
need not agree (the TPU's strip seeding is not ported).

  * `philox4x32` / `keep_scale` -- the generator in plain int64 PyTorch ops,
    on any device. ops/attention.py draws its attention-dropout masks from
    it too, so the explicit attention path and the kernels agree.
  * `dropout` -- y = x * keep * scale over a contiguous tensor of any shape
    (the index is the flat row-major index), as a torch.autograd.Function
    whose backward is the same function of the gradient with the same seed.
    CUDA tensors go to the kernel (ops/csrc/dropout.cu), which raises on
    what it does not take; CPU tensors go to `dropout_plain`.
  * `split_seed` -- independent seeds for the sites of one layer, the
    counterpart of jax.random.split.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from mmd_tpu_torch.ops import cuda_build

# Launches of the dropout kernel in this process; a run resets it to 0 and
# reads it back to show which path its dropouts took.
launches = 0
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold(rate: float) -> int:
    """Keep an element when its 32 random bits are below this."""
    return min(int((1.0 - rate) * 4294967296.0), 4294967295)


def split_seed(seed: int, n: int) -> list[int]:
    """n 64-bit seeds derived from one (splitmix64 of seed + i * golden)."""
    out = []
    for i in range(1, n + 1):
        z = (seed + i * 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        out.append(z ^ (z >> 31))
    return out


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 a < 2^32 and a 32-bit
    constant m, without leaving int64: m splits into 16-bit halves."""
    p1 = a * (m & 0xFFFF)                    # < 2^48
    p2 = a * (m >> 16)                       # < 2^48
    t = p1 + ((p2 & 0xFFFF) << 16)           # < 2^49
    return (t >> 32) + (p2 >> 16), t & _MASK32


def philox4x32(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
               c3: torch.Tensor, seed: int):
    """Philox4x32-10 on int64 tensors holding 32-bit counter words; the key
    is the seed's low and high 32 bits. Returns the four output words."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def random_bits(seed: int, n: int, device=None) -> torch.Tensor:
    """The 32-bit draws of elements 0 .. n-1, as int64 (n,)."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32(groups & _MASK32, groups >> 32, zero, zero,
                       seed & _MASK64)
    return torch.stack(words, dim=1).reshape(-1)[:n]


def keep_scale(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """fp32 multiplier of `shape`: 1 / (1 - rate) where the element at that
    row-major index is kept, 0 where it is dropped."""
    n = 1
    for s in shape:
        n *= s
    bits = random_bits(seed, n, device)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(bits < threshold(rate), scale,
                       torch.zeros((), dtype=torch.float32, device=device)
                       ).reshape(shape)


def dropout_plain(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the product in fp32, rounded
    once to x's dtype."""
    ks = keep_scale(seed, x.shape, rate, x.device)
    return (x.float() * ks).to(x.dtype)


def load_kernel():
    """Build (at first use) and load the kernel; returns its C entry point."""
    fn = cuda_build.load_library("dropout", ["dropout.cu"],
                                 ["philox.cuh"]).mmd_dropout
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_uint64, ctypes.c_uint32, ctypes.c_float,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _dropout_cuda(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    global launches
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes float32 or bfloat16, not "
                         f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the kernel takes a contiguous x")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    cuda_build.check_aligned(x, y)
    fn = load_kernel()
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), seed & _MASK64,
            threshold(rate), 1.0 / (1.0 - rate), _DTYPE_CODES[x.dtype],
            cuda_build.device_index(x),
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check_launch(rc, f"dropout {tuple(x.shape)} {x.dtype}")
    with _launch_lock:
        launches += 1
    return y


def _apply(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return dropout_plain(x, rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"dropout runs on cuda or cpu, not {x.device.type}")
    return _dropout_cuda(x, rate, seed)


class _Dropout(torch.autograd.Function):
    """The backward regenerates the mask from the seed (_dropout_core_bwd):
    dx = g * keep * scale, the same function of g."""

    @staticmethod
    def forward(ctx, x, rate, seed):
        ctx.rate, ctx.seed = rate, seed
        return _apply(x, rate, seed)

    @staticmethod
    def backward(ctx, g):
        return _apply(g.contiguous(), ctx.rate, ctx.seed), None, None


def dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Inverted dropout of a tensor of any shape; 0 < rate < 1."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must lie in (0, 1), not {rate}")
    return _Dropout.apply(x.contiguous(), rate, int(seed))
