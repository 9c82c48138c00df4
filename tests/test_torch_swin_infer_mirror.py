"""The Hopper Swin serving forward's order of work
(mmd_tpu_torch/ops/csrc/swin_window_attn.cu over swin_fwd.cuh,
Inputs::kRaw), mirrored in fp32 PyTorch and held against the port's plain
version `swin_window_attention_infer_plain` and the JAX package's
`swin_window_attention_infer` (its Pallas kernel in interpret mode, the bias
and scale converted to the log2 domain as tests/test_torch_swin.py does).

The mirror does what one CTA does for its (head, window, group of batch
rows), lane by lane where the kernel's index arithmetic decides the result:
it reads the (bw, h) bias tile once into each lane's score fragment (bw = 0
when one tile serves every window), times log2(e); it walks the group's
rows in order; each of the 4 warps takes its 16 query rows: the products on
the raw tiles, each lane's part of its two rows' squares (from the bf16 A
fragment, or the fp32 tile's columns 4 i + q) summed over the row's 4
lanes, the keys' norms that lane l computes for keys l and l + 32 handed to
the lanes whose score columns need them, then

    s2 = (q . k) * (scale log2(e) / max(|q|, 1e-12)) * (1 / max(|k|, 1e-12))
         + log2(e) bias,

the row max, exp2, the fp32 sum l, P rounded to bf16 where the input is
bf16, P V and the division by max(l, 1e-37).

Tolerances: fp32 within 2e-5 of the function's value in float64. At
logit scale 100 the log2-domain scores reach ~144, so an fp32 rounding of a
score moves P by ~1e-5 of itself: the mirror, the plain version and the
Pallas kernel (which normalizes before its product and packs g = 128 / dh
heads into one) each land 1.1e-5 to 1.9e-5 from the float64 value, and up to
2.5e-5 from one another. So the mirror is held within 2e-5 of the float64
value, and within twice that of the plain version and of the Pallas kernel.
A wrong fragment index or a missing log2(e) moves an output by O(1). With
P rounded to bf16, on inputs rounded to bf16, within one bf16 step at the
largest |output|: the card tests' tolerance, which that rounding must fit.
"""

import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import swin_attention as JSA
from mmd_tpu_torch.ops import cuda_build
from mmd_tpu_torch.ops import swin_attention as TSA

torch.set_num_threads(2)

N = 64                         # tokens a window
WARPS = 4                      # 16 query rows each
NT = 8                         # n8 tiles of a score row
LOG2E = 1.4426950408889634
TOL = 2e-5

# a lane's (g, q) and its score fragment's entries (nt, e): row g + 8 (e >> 1)
# of the warp's 16, key 8 nt + 2 q + (e & 1)
LANE = torch.arange(32)
G, Q = LANE // 4, LANE % 4
_NT = torch.arange(NT)[None, :, None]
_E = torch.arange(4)[None, None, :]
FRAG_ROW = (G[:, None, None] + 8 * (_E >> 1)).expand(32, NT, 4)
FRAG_COL = (8 * _NT + 2 * Q[:, None, None] + (_E & 1)).expand(32, NT, 4)


def _bf16(x):
    return x.bfloat16().float()


def _bias_fragment(tile, warp):
    """The warp's bias registers, as the kernel reads them: from
    bt = tile + (16 warp + g) N + 2 q, the float2 at bt + 8 r N + 8 nt."""
    flat = tile.reshape(-1)
    idx = ((16 * warp + G[:, None, None]) * N + 2 * Q[:, None, None]
           + 8 * (_E >> 1) * N + 8 * _NT + (_E & 1))
    return flat[idx] * LOG2E                                 # (32, NT, 4)


def _row_squares(qw, bf16):
    """Each lane's part of the squares of its rows g and g + 8 (32, 2):
    from the A fragment in bf16 (a0, a2 row g, a1, a3 row g + 8, at columns
    16 ks + 2 q + 8 (i >> 1) + {0, 1}), from columns 4 i + q in fp32."""
    dh = qw.shape[1]
    ss = torch.zeros(32, 2)
    for r in range(2):
        rows = qw[G + 8 * r]                                 # (32, dh)
        if bf16:
            cols = torch.stack([16 * ks + 2 * Q + 8 * hi + j
                                for ks in range(dh // 16)
                                for hi in range(2) for j in range(2)], 1)
        else:
            cols = torch.stack([4 * i + Q for i in range(dh // 4)], 1)
        ss[:, r] = (rows.gather(1, cols) ** 2).sum(1)
    return ss


def _quad(x, op):
    """Two xor shuffles over the 4 lanes of a row: every lane gets the
    quad's result."""
    shape = x.shape
    y = x.reshape(8, 4, *shape[1:])
    y = y.sum(1) if op == "sum" else y.amax(1)
    return y[:, None].expand(8, 4, *shape[1:]).reshape(shape)


def _key_factors(kt):
    """1 / max(|k|, 1e-12) at each lane's score columns (32, NT, 2): lane l
    computes keys l and l + 32; column 8 nt + 2 q + j comes from lane
    (8 nt + 2 q) mod 32 + j, its second key when nt >= NT / 2."""
    inv = 1.0 / (kt ** 2).sum(1).sqrt().clamp_min(1e-12)
    held = torch.stack([inv[LANE], inv[LANE + 32]], 1)       # (32, 2)
    kf = torch.empty(32, NT, 2)
    for nt in range(NT):
        src = (8 * nt + 2 * Q) & 31
        for j in range(2):
            kf[:, nt, j] = held[src + j, int(nt >= NT // 2)]
    return kf


def _warp(qw, kt, vt, bs, qscale, bf16):
    """One warp, one batch row: qw its 16 raw query rows, kt and vt the
    row's raw 64 x dh tiles -> its 16 output rows."""
    qf = qscale / _quad(_row_squares(qw, bf16), "sum").sqrt().clamp_min(1e-12)
    kf = _key_factors(kt)
    dot = qw @ kt.T                                          # (16, 64)
    s2 = (dot[FRAG_ROW, FRAG_COL] * qf[:, None, (_E >> 1)[0, 0]]
          * kf[:, :, (_E & 1)[0, 0]] + bs)
    mx = torch.stack([s2[:, :, 2 * r:2 * r + 2].amax((1, 2))
                      for r in range(2)], 1)
    mx = _quad(mx, "max")
    p = torch.exp2(s2 - mx[:, None, (_E >> 1)[0, 0]])
    l = _quad(torch.stack([p[:, :, 2 * r:2 * r + 2].sum((1, 2))
                           for r in range(2)], 1), "sum")
    if bf16:                                 # the A operand of P V
        p = _bf16(p)
    w = torch.zeros(16, N)
    w[FRAG_ROW, FRAG_COL] = p
    out = torch.empty(16, vt.shape[1])
    acc = w @ vt
    for r in range(2):
        out[G + 8 * r] = acc[G + 8 * r] / l[:, r:r + 1].clamp_min(1e-37)
    return out


def mirror(q, k, v, bias, scale, heads, groups, bf16=False):
    """The kernel's grid: (head, window, group) CTAs over raw (nW, B, 64, C)
    inputs, bias (1 or nW, heads, 64, 64) natural log, scale (heads,) ->
    (nW, B, 64, C) fp32."""
    nw, b, n, c = q.shape
    dh = c // heads
    per = b // groups
    out = torch.zeros(nw, b, n, c)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qscale = float(scale[h]) * LOG2E
        for w in range(nw):
            bw = 0 if bias.shape[0] == 1 else w
            for grp in range(groups):
                # the bias registers, once for the CTA
                bs = [_bias_fragment(bias[bw, h], wp) for wp in range(WARPS)]
                for i in range(grp * per, (grp + 1) * per):   # its rows
                    qt, kt, vt = (x[w, i, :, cols] for x in (q, k, v))
                    for wp in range(WARPS):
                        rows = slice(16 * wp, 16 * wp + 16)
                        out[w, i, rows, cols] = _warp(qt[rows], kt, vt,
                                                      bs[wp], qscale, bf16)
    return out


def _inputs(nw, b, c, heads, shifted, seed):
    """Raw q, k, v with a zero q row and a zero k row; the position bias in
    (0, 16) plus, for shifted blocks, twice a 0 / -100 region mask (one
    tile for every window otherwise); logit scales at and past the clamp of
    100."""
    rng = np.random.default_rng(seed)
    dh = c // heads
    q, k, v = (rng.standard_normal((nw, b, N, c)).astype(np.float32)
               for _ in range(3))
    q[0, 0, 5, :dh] = 0.0
    k[nw - 1, b - 1, 7, c - dh:] = 0.0
    cpb = (16 * rng.random((heads, N, N))).astype(np.float32)
    if shifted:
        bias = (cpb[None] - 200.0 * (rng.random((nw, 1, N, N)) < 0.3)
                ).astype(np.float32)
    else:
        bias = cpb[None]
    logit = np.log(np.array([100.0, 300.0, 2.0, 10.0][:heads], np.float32))
    scale = np.exp(np.minimum(logit, math.log(100.0))).astype(np.float32)
    return q, k, v, np.ascontiguousarray(bias), scale


def _jax(q, k, v, bias, scale, heads):
    nw, c = q.shape[0], q.shape[-1]
    full = np.broadcast_to(bias, (nw, *bias.shape[1:]))
    scale_row = np.broadcast_to(np.repeat(scale * LOG2E, c // heads)[None],
                                (8, c)).astype(np.float32)
    return np.asarray(JSA.swin_window_attention_infer(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(full * LOG2E), jnp.asarray(scale_row), heads))


def _float64(q, k, v, bias, scale, heads):
    """The function in float64: the plain version's formula."""
    nw, b, n, c = q.shape
    qh, kh, vh = (TSA._split(torch.from_numpy(x).double(), heads)
                  for x in (q, k, v))
    qh = qh / qh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kh = kh / kh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    s = (qh @ kh.transpose(-1, -2)) * torch.from_numpy(scale).double()[
        :, None, None] + torch.from_numpy(bias).double()[:, None]
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(2, 3).reshape(nw, b, n, c).numpy()


def _gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


# (nW, B, C, heads, shifted): head dim 32, shifted (a bias tile a window)
# and not (one for all); head dim 64; B 5 (prime: one group or five)
GEOMS = [(4, 3, 128, 4, True), (4, 2, 128, 4, False), (2, 5, 128, 2, True),
         (1, 4, 64, 2, False)]


@pytest.mark.parametrize("nw,b,c,heads,shifted", GEOMS)
def test_mirror_matches_plain_and_jax(nw, b, c, heads, shifted):
    """fp32: the mirror at the wrapper's batch split and at one group (one
    CTA walks every row) against the plain version and the JAX package's
    Pallas kernel."""
    q, k, v, bias, scale = _inputs(nw, b, c, heads, shifted, seed=nw + b + c)
    t = [torch.from_numpy(x) for x in (q, k, v, bias, scale)]
    exact = _float64(q, k, v, bias, scale, heads)
    plain = TSA.swin_window_attention_infer_plain(*t, heads).numpy()
    want = _jax(q, k, v, bias, scale, heads)
    for groups in sorted({TSA.batch_groups(nw, b, heads), 1}):
        got = mirror(*t, heads, groups)
        assert np.isfinite(got.numpy()).all()
        assert _gap(got, exact) <= TOL, (groups, _gap(got, exact))
        assert _gap(got, plain) <= 2 * TOL, (groups, _gap(got, plain))
        assert _gap(got, want) <= 2 * TOL, (groups, _gap(got, want))
    # the zero q row attends by the bias alone
    dh = c // heads
    alone = torch.softmax(t[3][0, 0, 5].double(), 0) @ t[2][0, 0, :, :dh].double()
    assert _gap(got[0, 0, 5, :dh], alone) <= TOL


@pytest.mark.parametrize("nw,b,c,heads,shifted", GEOMS)
def test_mirror_with_bf16_weights_within_a_bf16_step(nw, b, c, heads,
                                                     shifted):
    """bf16's order of work: inputs rounded to bf16 on both sides (exact as
    the kernel's operands), the bf16 A fragment's squares, P rounded to
    bf16 before P V; within one bf16 step of the plain version at logit
    scale 100, and not equal to the fp32 order (the rounding is there)."""
    q, k, v, bias, scale = _inputs(nw, b, c, heads, shifted, seed=3 * nw + b)
    t = [_bf16(torch.from_numpy(x)) for x in (q, k, v)]
    tb, ts = torch.from_numpy(bias), torch.from_numpy(scale)
    ref = TSA.swin_window_attention_infer_plain(*t, tb, ts, heads)
    groups = TSA.batch_groups(nw, b, heads)
    got = mirror(*t, tb, ts, heads, groups, bf16=True)
    step = 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)
    gap = _gap(got, ref)
    assert gap <= step, (gap, step)
    assert _gap(got, mirror(*t, tb, ts, heads, groups)) > 0


@pytest.mark.parametrize("entry", sorted(TSA._ENTRIES))
def test_bindings_match_the_entry_points(entry):
    """The wrappers' ctypes argtypes against the C entry points' parameters
    (a pointer is c_void_p, an int c_int): ctypes refuses a call with too
    few arguments only on the card, and cuts a pointer passed as an int."""
    library, argtypes = TSA._ENTRIES[entry]
    text = (cuda_build.CSRC / f"{library}.cu").read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in m.group(1).split(",")]
    assert all("*" in p or p.split()[0] == "int"
               for p in m.group(1).split(","))
    assert argtypes == want
