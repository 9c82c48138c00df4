"""The Hopper (residual +) LayerNorm's order of work
(mmd_tpu_torch/ops/csrc/layernorm.cu), mirrored in numpy and held against
the port's plain version `fused_layernorm_plain` and the JAX package's
`fused_layernorm` (its Pallas kernel in interpret mode, as
tests/test_torch_ln.py runs it).

The mirror does what the kernel's warps do: the grid is min(the blocks of
8 warps that give each warp a tile, the blocks the card holds); warp w of
block b walks tiles of TR rows b 8 + w, b 8 + w + 8 grid, ...; its k-th
tile goes through stage k % STAGES of the warp's own ring. Lane 0 issues
the first STAGES tiles' bulk copies of y (and the shortcut) at once, each
counted on its stage's barrier, and refills a stage after the warp has
read it; the warp waits on a stage by parity. The barriers are modelled as
PTX defines them (a phase completes when its arrivals are in and its
transaction bytes have landed; a wait on parity P passes while the
completed phases' count differs from P in parity), and the copies land in
a seeded random order. Inside a tile, row group g is row g RPW + lane /
LPR; lane sub = lane % LPR holds chunks i LPR + sub of it (16 bytes each),
sums them in order in fp32, and a butterfly over the row's LPR lanes (16 at
C 128 in bf16: two rows a warp) gives every lane the row's sum; the same
for the squared deviations; then out = (y - mean) rstd scale + bias (+
shortcut) in fp32.

Tolerance: 1e-6 of the largest |output| between the mirror (fp32, the
kernel's order of sums) and the plain version or the Pallas kernel (fp32,
their own orders): the orders of the sums, and the kernel's fused
multiply-adds, move the mean and variance by a few fp32 roundings, ~1e-7
of the output. A wrong chunk, row, stage or parity moves an output by O(1)
or deadlocks the model.
"""

import ctypes
import re
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import ln as JLN
from mmd_tpu_torch.models import layers as tL
from mmd_tpu_torch.ops import cuda_build
from mmd_tpu_torch.ops import ln as TLN

torch.set_num_threads(2)

WARPS = 8
TILE_TARGET = 2 * 1024
RING_TARGET = 96 * 1024
EPS = 1e-5
TOL = 1e-6
F32 = np.float32


@dataclass(frozen=True)
class Geo:
    c: int
    itemsize: int
    res: bool

    @property
    def v(self):                       # values a 16-byte chunk
        return 16 // self.itemsize

    @property
    def row_bytes(self):
        return self.c * self.itemsize

    @property
    def lpr(self):                     # lanes a row
        return 32 if (self.row_bytes // 16) % 32 == 0 else 16

    @property
    def rpw(self):                     # rows a warp at once
        return 32 // self.lpr

    @property
    def per(self):                     # chunks a lane holds of a row
        return self.row_bytes // 16 // self.lpr

    @property
    def rg(self):                      # row groups a tile
        return max(1, TILE_TARGET // (self.rpw * self.row_bytes))

    @property
    def tr(self):                      # rows a tile
        return self.rpw * self.rg

    @property
    def stage_bytes(self):
        return self.tr * self.row_bytes * (2 if self.res else 1)

    @property
    def stages(self):                  # of each warp's ring
        return min(4, max(2, RING_TARGET // (WARPS * self.stage_bytes)))


def _lane_columns(geo):
    """(LPR, PER V): the columns lane sub holds, in the order it sums them."""
    return np.array([[(i * geo.lpr + sub) * geo.v + e
                      for i in range(geo.per) for e in range(geo.v)]
                     for sub in range(geo.lpr)])


def _seq_sum(vals):
    """fp32 sum over the last axis, one value after another."""
    acc = np.zeros(vals.shape[:-1], F32)
    for j in range(vals.shape[-1]):
        acc = acc + vals[..., j]
    return acc


def _butterfly(acc, lpr):
    """x += shfl_xor(x, off) for off = LPR / 2 .. 1, over axis 1."""
    lanes = np.arange(lpr)
    for off in (16, 8, 4, 2, 1):
        if off < lpr:
            acc = acc + acc[:, lanes ^ off]
    return acc


def norm_rows(geo, yrows, xrows, scale, bias):
    """The kernel's arithmetic on rows (n, C) fp32 -> (n, C) fp32."""
    cols = _lane_columns(geo)
    vals = yrows[:, cols]                                     # (n, LPR, PER V)
    total = _butterfly(_seq_sum(vals), geo.lpr)
    assert (total == total[:, :1]).all()       # every lane holds the same sum
    mean = total[:, 0] / F32(geo.c)
    sq = _butterfly(_seq_sum(np.square(vals - mean[:, None, None])), geo.lpr)
    rstd = F32(1) / np.sqrt(sq[:, 0] / F32(geo.c) + F32(EPS))
    out = (yrows - mean[:, None]) * rstd[:, None] * scale + bias
    return out if xrows is None else out + xrows


class Barrier:
    def __init__(self, count):
        self.count, self.arrived, self.tx, self.completed = count, 0, 0, 0

    def passes(self, parity):
        return self.completed % 2 != parity

    def expect_tx(self, n):
        self.tx += n

    def arrive(self):
        self.arrived += 1
        self._complete()

    def land(self, n):
        self.tx -= n
        self._complete()

    def _complete(self):
        if self.arrived == self.count and self.tx == 0:
            self.completed += 1
            self.arrived = 0


def run_warp(geo, gw, warps, y, x, scale, bias, out, written, rng):
    """One warp's walk (warp gw of `warps`), its copies landing in a seeded
    random order."""
    rows, c = y.shape
    tiles = list(range(gw, -(-rows // geo.tr), warps))
    S = geo.stages
    stage_y = np.full((S, geo.tr, c), np.nan, F32)          # stale until filled
    stage_x = np.full((S, geo.tr, c), np.nan, F32)
    tag = np.full((S, geo.tr), -1)                          # tile a stage row holds
    full = [Barrier(1) for _ in range(S)]
    state = {"released": 0}                                 # turns read and done
    in_flight = []

    def fill(k):                                            # lane 0
        s, t = k % S, tiles[k]
        nr = min(geo.tr, rows - t * geo.tr)
        nbytes = nr * geo.row_bytes
        full[s].expect_tx(2 * nbytes if geo.res else nbytes)
        in_flight.append((k, s, t, nr, y))
        if geo.res:
            in_flight.append((k, s, t, nr, x))
        full[s].arrive()

    def land():
        k, s, t, nr, src = in_flight.pop(rng.integers(len(in_flight)))
        # no stage is refilled before the warp has read it
        assert state["released"] >= k - S + 1, (k, state)
        dst = stage_y if src is y else stage_x
        dst[s, :nr] = src[t * geo.tr:t * geo.tr + nr]
        tag[s, :nr] = t
        full[s].land(nr * geo.row_bytes)

    def warp():
        for k in range(min(S, len(tiles))):
            fill(k)
        for k, t in enumerate(tiles):
            s = k % S
            parity = (k // S) & 1
            yield lambda: full[s].passes(parity)
            nr = min(geo.tr, rows - t * geo.tr)
            lr = np.array([g * geo.rpw + h for g in range(geo.rg)
                           for h in range(geo.rpw)])
            lr = lr[lr < nr]
            assert (tag[s, lr] == t).all(), (t, tag[s, lr])
            got = norm_rows(geo, stage_y[s, lr],
                            stage_x[s, lr] if geo.res else None, scale, bias)
            out[t * geo.tr + lr] = got
            written[t * geo.tr + lr] += 1
            state["released"] = k + 1
            if k + S < len(tiles):
                fill(k + S)

    prog = warp()
    wait = next(prog, None)
    while wait is not None:
        if wait() and (not in_flight or rng.random() < 0.5):
            wait = next(prog, None)
        else:
            assert in_flight, "deadlock"
            land()
    assert not in_flight


def mirror(geo, y, x, scale, bias, resident, seed=0):
    """The whole grid: every warp's walk. -> (out fp32, times each row was
    written)."""
    rows = y.shape[0]
    tiles = -(-rows // geo.tr)
    grid = min(-(-tiles // WARPS), resident)
    out = np.full(y.shape, np.nan, F32)
    written = np.zeros(rows, int)
    rng = np.random.default_rng(seed)
    for gw in range(grid * WARPS):
        run_warp(geo, gw, grid * WARPS, y, x, scale, bias, out, written, rng)
    return out, written


def _inputs(rows, c, res, bf16, seed):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, c)) * 3 + 1).astype(F32)
    x = rng.standard_normal((rows, c)).astype(F32) if res else None
    if bf16:   # the bf16 kernel's inputs: exact in fp32
        y = torch.from_numpy(y).bfloat16().float().numpy()
        x = None if x is None else torch.from_numpy(x).bfloat16().float().numpy()
    scale = rng.standard_normal(c).astype(F32)
    bias = rng.standard_normal(c).astype(F32)
    return y, x, scale, bias


def _gap(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _row_cases(geo):
    """(rows, blocks the card holds): a ragged last tile (where a tile has
    more than one row), fewer rows than a tile (the same), and more tiles
    than warps: one block of 8 warps walks 2 STAGES + 1 tiles a warp or
    more, so each stage is refilled at least twice (both parities)."""
    tr = geo.tr
    return {"ragged": (27, 264),
            "below_a_tile": (max(1, tr // 2), 264),
            "more_tiles_than_warps": (tr * WARPS * (2 * geo.stages + 1) + 8,
                                      1)}


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("case", ["ragged", "below_a_tile",
                                  "more_tiles_than_warps"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 256, 384, 512, 1024])
def test_mirror_matches_plain_and_jax(c, dtype, case, res):
    bf16 = dtype == "bfloat16"
    geo = Geo(c, 2 if bf16 else 4, res)
    rows, resident = _row_cases(geo)[case]
    y, x, scale, bias = _inputs(rows, c, res, bf16, seed=c + rows)
    got, written = mirror(geo, y, x, scale, bias, resident, seed=rows)
    assert (written == 1).all()                 # every row exactly once
    mod = tL.layernorm_init(c)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        plain = TLN.fused_layernorm_plain(
            mod, torch.from_numpy(y), EPS,
            None if x is None else torch.from_numpy(x)).numpy()
    assert _gap(got, plain) <= TOL, _gap(got, plain)
    if rows % 8 == 0:                           # the Pallas kernel's rule
        assert JLN.fused_ln_ok(y.shape)
        want = np.asarray(JLN.fused_layernorm(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(y), EPS,
            shortcut=None if x is None else jnp.asarray(x)))
        assert _gap(got, want) <= TOL, _gap(got, want)


def test_a_wrong_parity_misreads():
    """The model catches a warp that waits on the wrong phase: with the
    parity flipped, it reads a stage before its tile has landed."""
    geo = Geo(256, 2, True)
    y, x, scale, bias = _inputs(9 * WARPS * geo.tr, 256, True, True, seed=5)
    orig = Barrier.passes
    Barrier.passes = lambda self, parity: self.completed % 2 == parity
    try:
        with pytest.raises(AssertionError):
            mirror(geo, y, x, scale, bias, 1)
    finally:
        Barrier.passes = orig


@pytest.mark.parametrize("c,itemsize,res,lpr,rows_a_tile,stages", [
    (128, 2, False, 16, 8, 4), (128, 2, True, 16, 8, 3),
    (256, 2, True, 32, 4, 3), (512, 2, True, 32, 2, 3),
    (1024, 2, True, 32, 1, 3), (1024, 2, False, 32, 1, 4),
    (384, 2, True, 16, 2, 4), (768, 2, True, 32, 1, 4),
    (128, 4, True, 32, 4, 3), (1024, 4, True, 32, 1, 2)])
def test_geometry_at_the_served_widths(c, itemsize, res, lpr, rows_a_tile,
                                       stages):
    """Two rows a warp at C 128 in bf16 (16 lanes each, one chunk a lane: no
    lane idles); ~2 KB a tensor's tile; rings of 2-4 stages, ~96 KB a
    block."""
    geo = Geo(c, itemsize, res)
    assert (geo.lpr, geo.tr, geo.stages) == (lpr, rows_a_tile, stages)
    assert geo.per * geo.lpr * geo.v == c
    assert WARPS * geo.stages * geo.stage_bytes <= 128 * 1024


def test_constants_match_the_kernel():
    text = (cuda_build.CSRC / "layernorm.cu").read_text()

    def const(name):
        m = re.search(r"constexpr int " + name + r" = ([0-9* ]+);", text)
        return eval(m.group(1))                 # noqa: S307 -- digits and *

    assert (const("WARPS"), const("TILE_TARGET"), const("RING_TARGET")) == (
        WARPS, TILE_TARGET, RING_TARGET)


def test_every_entry_point_is_bound():
    """layernorm.cu exports just the entry points the wrapper binds: no C
    entry point is left that no path calls."""
    text = (cuda_build.CSRC / "layernorm.cu").read_text()
    assert set(re.findall(r'extern "C" int (\w+)\(', text)) == set(
        TLN._ENTRIES)


@pytest.mark.parametrize("entry", sorted(TLN._ENTRIES))
def test_bindings_match_the_entry_points(entry):
    """The wrapper's ctypes argtypes against the C entry points' parameters
    (a pointer is c_void_p, an int c_int, a float c_float): ctypes refuses a
    call with too few arguments only on the card, and cuts a pointer passed
    as an int."""
    text = (cuda_build.CSRC / "layernorm.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    params = [p.strip() for p in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
            for p in params]
    assert TLN._ENTRIES[entry] == want
