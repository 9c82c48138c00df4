"""The Hopper fused GELU-MLP forward's order of work
(mmd_tpu_torch/ops/csrc/mlp_fwd.cu), mirrored in PyTorch and held against
the port's plain version `fused_mlp_plain` and the JAX package's
`_fused_mlp_core` (its Pallas kernel in interpret mode, at rate 0: the TPU
PRNG behind its masks has no interpret mode).

The mirror does what one CTA does for its 128-row tile: x's missing rows
read zeros; F is walked in chunks of 64 columns; a chunk's hidden keep bits
are drawn from Philox at the absolute index row * F + c0 + j lane by lane,
as each consumer lane draws its own elements' bits into a register
(mlp_fwd.cu::hidden_keep); a = x w1[:, chunk] + b1, GELU, times the keep
bit and the scale, h rounded to bf16 where the input is bf16; y += h
w2[chunk, :] chunk by chunk in F order in fp32; then (y + b2) m2, the
output bits packed a byte per 8 columns and read back as the kernel's
tail reads them, rounded once, and only the tile's real rows stored.
GELU takes the tanh both kernels take (mlp_common.cuh's 1 - 2 / (1 +
e^2u), ex2 and rcp on the card), and its error against float64 is bounded
element by element.

It also pins the register maps the kernel relies on: which (row, column)
of the m64nN wgmma accumulator each lane's registers hold, which (row, k)
of a k16 A fragment each register holds, and that packing accumulator
registers 8 t + 2 i and 8 t + 2 i + 1 gives the A fragment of the hidden
columns 16 t .. 16 t + 15 (h goes from the first product to the second
without leaving registers). And it holds every MLP entry point's ctypes
binding against its C signature: ctypes refuses a call with too few
arguments only on the card, and cuts a 64-bit value passed as an int.

Tolerances: fp32 within 1e-5 of each output's largest |value| (fp32
summation order); bf16 within one bf16 step at
the largest |y| (an h that rounds the other way after fp32 sums in another
order, then y's own rounding); the JAX kernel, fp32 at rate 0, within
2e-5 of the largest |y|, as tests/test_torch_mlp.py holds the plain
version to it.
"""

import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops.mlp import _fused_mlp_core
from mmd_tpu_torch.ops import cuda_build
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops import mlp as M

torch.set_num_threads(2)

BM, FC = 128, 64               # rows a CTA; hidden columns a chunk
LANE = np.arange(32)
G, Q = LANE // 4, LANE % 4


# -- the register maps -----------------------------------------------------------

def accumulator_map(n: int) -> np.ndarray:
    """(4 warps, 32 lanes, n / 2 registers, 2) -> (row, column) of the 64 x n
    fp32 accumulator of wgmma m64nNk16: register 4 j + 2 h + e of lane
    (g, q) in warp w holds row 16 w + g + 8 h, column 8 j + 2 q + e."""
    out = np.zeros((4, 32, n // 2, 2), np.int64)
    for w in range(4):
        for i in range(n // 2):
            j, h, e = i // 4, (i // 2) % 2, i % 2
            out[w, :, i, 0] = 16 * w + G + 8 * h
            out[w, :, i, 1] = 8 * j + 2 * Q + e
    return out


def a_fragment_map() -> np.ndarray:
    """(4 warps, 32 lanes, 4 registers, 2 halves) -> (row, k) of the 64 x 16
    bf16 A operand of wgmma from registers: register i of lane (g, q) in
    warp w holds row 16 w + g + 8 (i % 2), columns 8 (i / 2) + 2 q (low
    half) and + 1 (high half)."""
    out = np.zeros((4, 32, 4, 2, 2), np.int64)
    for w in range(4):
        for i in range(4):
            for e in range(2):
                out[w, :, i, e, 0] = 16 * w + G + 8 * (i % 2)
                out[w, :, i, e, 1] = 8 * (i // 2) + 2 * Q + e
    return out


def _covers_once(cells: np.ndarray, rows: int, cols: int) -> bool:
    flat = cells.reshape(-1, 2)
    idx = flat[:, 0] * cols + flat[:, 1]
    return (flat[:, 0].min() >= 0 and flat[:, 0].max() < rows
            and flat[:, 1].min() >= 0 and flat[:, 1].max() < cols
            and np.array_equal(np.sort(idx), np.arange(rows * cols)))


@pytest.mark.parametrize("n", [64, 128, 256])
def test_accumulator_map_is_a_permutation(n):
    """The m64n64 hidden block and the m64n128 / m64n256 y blocks: every
    element once."""
    assert _covers_once(accumulator_map(n), 64, n)


def test_a_fragments_come_from_the_hidden_accumulator():
    """The kernel packs h[t][i] = bf16x2(acc[8 t + 2 i], acc[8 t + 2 i + 1]):
    each register half then holds the A-fragment element the product
    expects, for each k16 step t, and the four steps cover the 64 x 64
    block once."""
    acc = accumulator_map(64)
    frag = a_fragment_map()
    assert _covers_once(frag, 64, 16)
    cells = []
    for t in range(4):
        for i in range(4):
            for e in range(2):
                have = acc[:, :, 8 * t + 2 * i + e]
                want = frag[:, :, i, e] + np.array([0, 16 * t])
                assert np.array_equal(have, want), (t, i, e)
                cells.append(have)
    assert _covers_once(np.stack(cells), 64, 64)


# -- the order of work -----------------------------------------------------------

def _tanh_fast(u: torch.Tensor) -> torch.Tensor:
    """mlp_common.cuh's tanh: 1 - 2 / (1 + e^2u)."""
    return 1.0 - 2.0 / (1.0 + torch.exp(2.0 * u))


def _gelu_fast(a: torch.Tensor) -> torch.Tensor:
    """mlp_common.cuh::gelu_tanh_and_grad_fast's g, in fp32 as the
    kernels take it."""
    return 0.5 * a * (1.0 + _tanh_fast(M._C * (a + M._K * a * a * a)))


def _keep_tile(seed, rate: float, row0: int, rows: int, ld: int, c0: int,
               cols: int) -> torch.Tensor:
    """keep * scale of rows row0.., columns c0 .. c0 + cols of a (rows, ld)
    mask, as the kernel stores the output mask's bits and reads them: bytes
    of 8 columns from the Philox draws at the absolute index, then bit c % 8
    of byte c / 8."""
    if seed is None:
        return torch.ones(rows, cols)
    r = torch.arange(rows, dtype=torch.int64)[:, None] + row0
    idx = r * ld + c0 + torch.arange(cols, dtype=torch.int64)
    group = idx >> 2
    words = D.philox4x32(group & 0xFFFFFFFF, group >> 32,
                         torch.zeros_like(group), torch.zeros_like(group),
                         seed)
    bits = torch.stack(words, -1).gather(-1, (idx & 3)[..., None])[..., 0]
    keep = (bits < D.threshold(rate)).to(torch.int64)
    packed = (keep.reshape(rows, cols // 8, 8)
              << torch.arange(8, dtype=torch.int64)).sum(-1)   # the bytes
    col = torch.arange(cols)
    read = (packed[:, col // 8] >> (col % 8)) & 1
    return read.float() * torch.tensor(1.0 / (1.0 - rate))


def _hidden_keep_tile(seed, rate: float, row0: int, f: int,
                      c0: int) -> torch.Tensor:
    """keep * scale of the tile's BM x FC block of the hidden mask at column
    c0, as mlp_fwd.cu::hidden_keep draws it lane by lane: lane (g, q) of
    warp w in warpgroup wg owns rows r = 64 wg + 16 w + g and r + 8; the
    even lane of a pair draws row r's Philox groups, the odd one row r + 8's
    (group ((row0 + row) F + c0 + 4 (q / 2)) / 4 + 2 j for column block j),
    each keeps a nibble of keep bits a group, one shuffle (lane ^ 1) swaps
    them, and the lane keeps its two lanes of each nibble, bit 4 j + 2 h + e
    for element (r + 8 h, 8 j + 2 q + e)."""
    if seed is None:
        return torch.ones(BM, FC)
    t = torch.arange(2 * 128, dtype=torch.int64)
    lane, q = t % 32, t % 4
    r = (t // 128) * 64 + (t // 32 % 4) * 16 + lane // 4
    odd = q & 1
    group = (((row0 + r + 8 * odd) * f + c0 + 4 * (q >> 1)) >> 2)[:, None] \
        + 2 * torch.arange(8, dtype=torch.int64)
    words = torch.stack(D.philox4x32(group & 0xFFFFFFFF, group >> 32,
                                     torch.zeros_like(group),
                                     torch.zeros_like(group), seed), -1)
    nibble = (words < D.threshold(rate)).to(torch.int64) \
        << torch.arange(4, dtype=torch.int64)
    mine = (nibble.sum(-1) << 4 * torch.arange(8, dtype=torch.int64)).sum(-1)
    other = mine[t ^ 1]
    half = torch.where(odd == 1, 0xCCCCCCCC, 0x33333333)
    row_r = torch.where(odd == 1, other, mine)
    row_r8 = torch.where(odd == 1, mine, other)
    keep = ((row_r & half) >> (2 * odd)) | (((row_r8 & half) >> (2 * odd)) << 2)
    tile = torch.zeros(BM, FC)
    for j in range(8):
        for h in range(2):
            for e in range(2):
                bit = (keep >> (4 * j + 2 * h + e)) & 1
                tile[r + 8 * h, 8 * j + 2 * q + e] = bit.float()
    return tile * torch.tensor(1.0 / (1.0 - rate))


def mirror(x2, w1, b1, w2, b2, seeds, rate):
    n, d = x2.shape
    f = w1.shape[1]
    bf16 = x2.dtype == torch.bfloat16
    s1, s2 = seeds if seeds is not None else (None, None)
    w1f, w2f, b1f, b2f = w1.float(), w2.float(), b1.float(), b2.float()
    out = torch.empty(n, d, dtype=x2.dtype)
    for row0 in range(0, n, BM):
        real = min(BM, n - row0)
        xt = torch.zeros(BM, d)
        xt[:real] = x2[row0:row0 + real].float()
        acc_y = torch.zeros(BM, d)
        for c0 in range(0, f, FC):
            a = xt @ w1f[:, c0:c0 + FC] + b1f[c0:c0 + FC]
            h = _gelu_fast(a) * _hidden_keep_tile(s1, rate, row0, f, c0)
            if bf16:
                h = h.to(torch.bfloat16).float()
            acc_y = acc_y + h @ w2f[c0:c0 + FC]
        y = (acc_y + b2f) * _keep_tile(s2, rate, row0, BM, d, 0, d)
        out[row0:row0 + real] = y[:real].to(x2.dtype)
    return out


def _inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    f = 4 * d
    return [torch.from_numpy(a).float() for a in (
        rng.standard_normal((n, d)),
        rng.standard_normal((d, f)) / math.sqrt(d),
        0.1 * rng.standard_normal(f),
        rng.standard_normal((f, d)) / math.sqrt(f),
        0.1 * rng.standard_normal(d))]


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want.double()).abs().max().item()


def test_tanh_fast_is_tanh():
    u = torch.linspace(-30.0, 30.0, 20001)
    assert _gap(_tanh_fast(u), torch.tanh(u)) <= 1e-6


def test_gelu_fast_against_float64():
    """Each element of the kernels' fp32 GELU within 1e-6 (1 + |a|) of the
    float64 tanh-GELU of the same a: t's absolute error, scaled by a / 2,
    beside fp32 rounding; far below the bf16 step of h (2^-8 relative)."""
    a = torch.linspace(-12.0, 12.0, 48001)
    a64 = a.double()
    want = 0.5 * a64 * (1.0 + torch.tanh(
        M._C * (a64 + M._K * a64 * a64 * a64)))
    err = (_gelu_fast(a).double() - want).abs()
    assert (err <= 1e-6 * (1.0 + a64.abs())).all(), err.max().item()


CASES = [(n, d) for n in (1, 65, 1000, 1088) for d in (128, 256)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,d", CASES)
def test_mirror_matches_plain_in_fp32(n, d, rate):
    x, w1, b1, w2, b2 = _inputs(n, d, seed=n + d)
    seeds = M.mask_seeds(rate, 4321 + n)
    got = mirror(x, w1, b1, w2, b2, seeds, rate)
    want = M.fused_mlp_plain(x, w1, b1, w2, b2, seeds, rate)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _gap(got, want) <= 1e-5 * want.abs().max().item()
    assert torch.equal(got == 0, want == 0) or rate == 0.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,d", CASES)
def test_mirror_in_bf16_within_one_bf16_step(n, d, rate):
    """bf16 inputs, h and y rounded where the kernel rounds them."""
    x, w1, b1, w2, b2 = _inputs(n, d, seed=3 * n + d)
    x, w1, w2 = (t.to(torch.bfloat16) for t in (x, w1, w2))
    seeds = M.mask_seeds(rate, 99 + n)
    got = mirror(x, w1, b1, w2, b2, seeds, rate)
    want = M.fused_mlp_plain(x, w1, b1, w2, b2, seeds, rate)
    assert got.dtype == want.dtype == torch.bfloat16
    peak = want.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert _gap(got, want) <= step, (_gap(got, want), step)


@pytest.mark.parametrize("n,d", CASES)
def test_mirror_matches_the_jax_kernel_at_rate_0(n, d):
    x, w1, b1, w2, b2 = _inputs(n, d, seed=7 * n + d)
    want = np.array(_fused_mlp_core(
        *(jnp.asarray(t.numpy()) for t in (x, w1, b1, w2, b2)),
        jnp.zeros((2,), jnp.int32), 0.0))
    got = mirror(x, w1, b1, w2, b2, None, 0.0)
    assert _gap(got, torch.from_numpy(want)) <= 2e-5 * np.abs(want).max()


def test_keep_tiles_are_the_plain_masks():
    """The hidden mask drawn lane by lane at row * F + c0 + j and the output
    mask packed and read back, tile by tile, are mlp_masks_plain's masks."""
    n, d, f, rate = 200, 128, 512, 0.1
    seeds = M.mask_seeds(rate, 5)
    m1, m2 = M.mlp_masks_plain(n, d, f, seeds, rate)
    for row0 in (0, 128):
        rows = min(BM, n - row0)
        got = torch.cat([_hidden_keep_tile(seeds[0], rate, row0, f, c0)
                         for c0 in range(0, f, FC)], 1)
        assert torch.equal(got[:rows], m1[row0:row0 + rows])
        assert torch.equal(_keep_tile(seeds[1], rate, row0, rows, d, 0, d),
                           m2[row0:row0 + rows])


# -- the bindings ----------------------------------------------------------------

_CTYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "uint64_t": ctypes.c_uint64, "uint32_t": ctypes.c_uint32,
           "float": ctypes.c_float}


@pytest.mark.parametrize("entry", sorted(M._ENTRIES))
def test_bindings_match_the_entry_points(entry):
    """Each MLP entry point's module-level argtypes and restype against
    its C declaration: a pointer is c_void_p, every other parameter the
    ctypes type of its C type."""
    library, argtypes, restype = M._ENTRIES[entry]
    text = (cuda_build.CSRC / f"{library}.cu").read_text()
    m = re.search(r'extern "C" (\w+) ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    want = [ctypes.c_void_p if "*" in p else _CTYPES[p.split()[0]]
            for p in m.group(2).split(",")]
    assert argtypes == want
    assert restype == _CTYPES[m.group(1)]
