"""The order of work of the Hopper Swin kernels at windows of n = 64 T
tokens, T > 1 (16 x 16: 256; 24 x 24: 576), mirrored in fp32 PyTorch and
held against the port's plain versions (which tests/test_torch_swin_window16.py
holds against the JAX package's Pallas kernels):

  * the blocked forward both #7 and #8 run (swin_fwd.cuh, forward_blocked):
    a CTA a (query tile, head, window, group of batch rows) walks the
    window's keys in blocks of 64 with an online softmax -- fp32 running max
    m and sum l, the accumulator rescaled by exp2(m_old - m_new), P rounded
    to bf16 before P V in bf16 relative to the RUNNING max, the final sum
    floored at 1e-37; #7's raw q and k scaled by their norms and the logit
    scale, its natural-log bias times log2(e);
  * the blocked backward #9 (swin_window_attn_train.cu): the query side
    walks a row's key blocks twice -- the statistics m, l and D = rowsum(P
    dP) online, then P, dS, dQ' and the dbias tile, added to in the group's
    row order -- and the key side makes dK and dV from the statistics; the
    groups' dbias parts summed in group order. In bf16 P and dS enter their
    products as hi + lo.

Tolerances: fp32 forwards within 3e-5 of the function's value in float64
and twice that of the plain versions. At logit scale 100 the log2-domain
scores reach ~144, so an fp32 rounding of a score moves P by ~1e-5 of
itself (the n-64 mirror's 2e-5); over 256 and 576 keys an output gathers
more such terms: the plain version lands 1.2e-5 to 2.0e-5 from the float64
value here, the mirror 1.7e-5 to 2.4e-5. Gradients within 1e-5 of each
one's largest |value| (tests/test_torch_swin_bwd_mirror.py's). bf16 P, on inputs rounded
to bf16 on both sides, within one bf16 step at the largest |output|, the
card tests' tolerance. The hi + lo weights within 1e-5 of the plain
version's with its `split_weights` (the mirror the card holds #9 to).
"""

import math

import numpy as np
import pytest
import torch

from mmd_tpu_torch.ops import swin_attention as TSA

torch.set_num_threads(2)

N = 64                         # a key block, a query tile
LN2 = 0.6931471805599453
LOG2E = 1.4426950408889634
TOL = 3e-5
REL = 1e-5


def _bf16(x):
    return x.bfloat16().float()


def _forward_tile(qt, k, v, bias_rows, qscale, raw, bf16):
    """One query tile of one batch row and head, as a CTA walks it: qt (64,
    dh), k and v (n, dh), bias_rows (64, n) as the kernel adds it (log2
    domain) -> (64, dh)."""
    n = k.shape[0]
    if raw:
        qf = qscale / qt.norm(dim=-1).clamp_min(1e-12)
    m = torch.full((N,), -math.inf)
    l = torch.zeros(N)
    acc = torch.zeros(N, v.shape[1])
    for kt in range(n // N):
        keys = slice(N * kt, N * kt + N)
        s = qt @ k[keys].T
        if raw:
            kf = 1.0 / k[keys].norm(dim=-1).clamp_min(1e-12)
            s = s * qf[:, None] * kf[None]
        s = s + bias_rows[:, keys]
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[:, None] + (_bf16(p) if bf16 else p) @ v[keys]
        m = m_new
    return acc / l.clamp_min(1e-37)[:, None]


def forward_mirror(q, k, v, bias, heads, scale=None, bf16=False):
    """The blocked grid over (nW, B, n, C) inputs. scale given: #7 (raw q
    and k, natural-log bias (1 or nW, heads, n, n)); else #8 (q', k, the
    log2-domain bias (nW, heads, n, n)) -> (nW, B, n, C) fp32."""
    nw, b, n, c = q.shape
    dh = c // heads
    raw = scale is not None
    out = torch.zeros(nw, b, n, c)
    for h in range(heads):
        cols = slice(h * dh, (h + 1) * dh)
        qscale = float(scale[h]) * LOG2E if raw else None
        for w in range(nw):
            tile = bias[0 if bias.shape[0] == 1 else w, h]
            tile = tile * LOG2E if raw else tile
            for i in range(b):
                for t in range(n // N):
                    rows = slice(N * t, N * t + N)
                    out[w, i, rows, cols] = _forward_tile(
                        q[w, i, rows, cols], k[w, i, :, cols],
                        v[w, i, :, cols], tile[rows], qscale, raw, bf16)
    return out


def _split(w, hilo):
    if not hilo:
        return w
    hi = _bf16(w)
    return hi + _bf16(w - hi)


def _query_side(qt, do_t, k, v, bias_rows, hilo):
    """One query tile of one batch row and head: the statistics pass (m, l
    and sum exp2(s - m) dP online), then the gradient pass -> dq (64, dh),
    the tile's dS (64, n) and m, 1 / l, D (64,) each."""
    n = k.shape[0]
    m = torch.full((N,), -math.inf)
    l = torch.zeros(N)
    dd = torch.zeros(N)
    for kt in range(n // N):
        keys = slice(N * kt, N * kt + N)
        s = qt @ k[keys].T + bias_rows[:, keys]
        dp = do_t @ v[keys].T
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[:, None])
        l = l * alpha + p.sum(dim=-1)
        dd = dd * alpha + (p * dp).sum(dim=-1)
        m = m_new
    inv = 1.0 / l.clamp_min(1e-37)
    d = dd * inv
    dq = torch.zeros_like(qt)
    ds_all = torch.zeros(N, n)
    for kt in range(n // N):
        keys = slice(N * kt, N * kt + N)
        s = qt @ k[keys].T + bias_rows[:, keys]
        dp = do_t @ v[keys].T
        p = torch.exp2(s - m[:, None]) * inv[:, None]
        ds = LN2 * p * (dp - d[:, None])
        ds_all[:, keys] = ds
        dq = dq + _split(ds, hilo) @ k[keys]
    return dq, ds_all, (m, inv, d)


def _key_side(kt_, v_t, q, do, bias_cols, stats, hilo):
    """One key tile of one batch row and head from the query side's
    statistics: kt_, v_t (64, dh), q, do (n, dh), bias_cols (n, 64) ->
    dk, dv (64, dh)."""
    n = q.shape[0]
    m, inv, d = stats
    dk = torch.zeros_like(kt_)
    dv = torch.zeros_like(v_t)
    for qt in range(n // N):
        qs = slice(N * qt, N * qt + N)
        st = kt_ @ q[qs].T + bias_cols[qs].T           # S^T (keys, queries)
        dpt = v_t @ do[qs].T
        pt = torch.exp2(st - m[qs][None]) * inv[qs][None]
        dst = LN2 * pt * (dpt - d[qs][None])
        dv = dv + _split(pt, hilo) @ do[qs]
        dk = dk + _split(dst, hilo) @ q[qs]
    return dk, dv


def backward_mirror(q, k, v, bias, do, heads, groups, hilo):
    """The blocked backward over (nW, B, n, C) inputs and the log2-domain
    bias (nW, heads, n, n) -> dq, dk, dv (nW, B, n, C), dbias."""
    nw, b, n, c = q.shape
    dh = c // heads
    per = b // groups
    dq, dk, dv = (torch.zeros(nw, b, n, c) for _ in range(3))
    dbias = torch.zeros(nw, heads, n, n)
    for w in range(nw):
        for h in range(heads):
            cols = slice(h * dh, (h + 1) * dh)
            parts = []
            for grp in range(groups):
                part = torch.zeros(n, n)          # the CTAs' tiles of it
                for i in range(grp * per, (grp + 1) * per):
                    x = [t[w, i, :, cols] for t in (q, k, v, do)]
                    m, inv, d = (torch.zeros(n) for _ in range(3))
                    for t in range(n // N):
                        rows = slice(N * t, N * t + N)
                        g, ds, st = _query_side(x[0][rows], x[3][rows],
                                                x[1], x[2],
                                                bias[w, h, rows], hilo)
                        dq[w, i, rows, cols] = g
                        part[rows] = part[rows] + ds   # in row order
                        m[rows], inv[rows], d[rows] = st
                    for t in range(n // N):
                        keys = slice(N * t, N * t + N)
                        gk, gv = _key_side(x[1][keys], x[2][keys], x[0],
                                           x[3], bias[w, h][:, keys],
                                           (m, inv, d), hilo)
                        dk[w, i, keys, cols] = gk
                        dv[w, i, keys, cols] = gv
                parts.append(part)
            acc = parts[0]                        # the groups' sum, in order
            for part in parts[1:]:
                acc = acc + part
            dbias[w, h] = acc
    return dq, dk, dv, dbias


def _serving_inputs(nw, b, n, c, heads, shifted, seed):
    """Raw q, k, v with a zero q row and a zero k row; the position bias in
    (0, 16) plus, for shifted blocks, twice a 0 / -100 region mask; logit
    scales at and past the clamp of 100."""
    rng = np.random.default_rng(seed)
    dh = c // heads
    q, k, v = (rng.standard_normal((nw, b, n, c)).astype(np.float32)
               for _ in range(3))
    q[0, 0, 5, :dh] = 0.0
    k[nw - 1, b - 1, n - 7, c - dh:] = 0.0
    cpb = (16 * rng.random((heads, n, n))).astype(np.float32)
    bias = (cpb[None] - 200.0 * (rng.random((nw, 1, n, n)) < 0.3)
            if shifted else cpb[None]).astype(np.float32)
    logit = np.log(np.array([100.0, 300.0, 2.0, 10.0][:heads], np.float32))
    scale = np.exp(np.minimum(logit, math.log(100.0))).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (q, k, v, bias, scale)]


def _train_inputs(nw, b, n, c, heads, seed):
    rng = np.random.default_rng(seed)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, b, n, heads, dh)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(
            nw, b, n, c).astype(np.float32)

    q = unit(rng.standard_normal((nw, b, n, c))) * np.float32(10 * LOG2E)
    k = unit(rng.standard_normal((nw, b, n, c)))
    v, do = (rng.standard_normal((nw, b, n, c)).astype(np.float32)
             for _ in range(2))
    bias = ((16 * rng.random((nw, heads, n, n))
             - 200 * (rng.random((nw, 1, n, n)) < 0.3)) * LOG2E
            ).astype(np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, bias, do)]


def _gap(a, b):
    return (a - b).abs().max().item()


def _float64(q, k, v, bias, heads, scale=None):
    """The forward's function in float64 (the plain versions' formulas): #7
    with `scale`, else #8."""
    nw, b, n, c = q.shape
    qh, kh, vh = (TSA._split(x.double(), heads) for x in (q, k, v))
    if scale is None:
        s = (qh @ kh.transpose(-1, -2) + bias.double()[:, None]) * LN2
    else:
        qh = qh / qh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        kh = kh / kh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        s = ((qh @ kh.transpose(-1, -2)) * scale.double()[:, None, None]
             + bias.double()[:, None])
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(2, 3).reshape(nw, b, n, c)


# (nW, B, n, C, heads, shifted): 16 x 16 windows at head dim 32, shifted
# and not, head dim 64; a 24 x 24 window
FWD_GEOMS = [(2, 2, 256, 64, 2, True), (1, 2, 256, 128, 2, False),
             (1, 1, 576, 64, 2, True)]


@pytest.mark.parametrize("nw,b,n,c,heads,shifted", FWD_GEOMS)
def test_forward_mirror_matches_plain(nw, b, n, c, heads, shifted):
    """fp32: #7's and #8's blocked order within 2e-5 of the function's
    value in float64 (the plain versions' formulas) and within twice that
    of the plain versions, as the n-64 mirror is held."""
    q, k, v, bias, scale = _serving_inputs(nw, b, n, c, heads, shifted,
                                           seed=n + c)
    got = forward_mirror(q, k, v, bias, heads, scale)
    exact = _float64(q, k, v, bias, heads, scale)
    want = TSA.swin_window_attention_infer_plain(q, k, v, bias, scale, heads)
    assert torch.isfinite(got).all()
    assert _gap(got.double(), exact) <= TOL, _gap(got.double(), exact)
    assert _gap(got, want) <= 2 * TOL, _gap(got, want)
    q2, k2, v2, b2, _ = _train_inputs(nw, b, n, c, heads, seed=n + 1)
    got = forward_mirror(q2, k2, v2, b2, heads)
    exact = _float64(q2, k2, v2, b2, heads)
    want = TSA.swin_window_attention_plain(q2, k2, v2, b2, heads)
    assert _gap(got.double(), exact) <= TOL, _gap(got.double(), exact)
    assert _gap(got, want) <= 2 * TOL, _gap(got, want)


@pytest.mark.parametrize("nw,b,n,c,heads,shifted", FWD_GEOMS)
def test_forward_mirror_with_bf16_weights_within_a_bf16_step(
        nw, b, n, c, heads, shifted):
    """bf16: P rounded to bf16 relative to the running max, on inputs
    rounded to bf16 on both sides, within one bf16 step of the plain
    version at logit scale 100, and not the fp32 order's result."""
    q, k, v, bias, scale = _serving_inputs(nw, b, n, c, heads, shifted,
                                           seed=3 * n + b)
    q, k, v = (_bf16(x) for x in (q, k, v))
    ref = TSA.swin_window_attention_infer_plain(q, k, v, bias, scale, heads)
    got = forward_mirror(q, k, v, bias, heads, scale, bf16=True)
    step = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    assert _gap(got, ref) <= step, (_gap(got, ref), step)
    assert _gap(got, forward_mirror(q, k, v, bias, heads, scale)) > 0


# (nW, B, n, C, heads): 16 x 16 windows at head dim 32 (B 4: one group,
# two, four) and head dim 64; a 24 x 24 window
BWD_GEOMS = [(1, 4, 256, 64, 2), (2, 1, 256, 64, 1), (1, 2, 576, 32, 1)]


def _close(got, want, what):
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert a.shape == w.shape, (what, name)
        gap = _gap(a, w)
        assert gap <= REL * w.abs().max().item(), (what, name, gap)


@pytest.mark.parametrize("nw,b,n,c,heads", BWD_GEOMS)
def test_backward_mirror_matches_plain(nw, b, n, c, heads):
    """fp32: the blocked backward at the wrapper's batch split and at one
    group and one group a row, against the plain version."""
    q, k, v, bias, do = _train_inputs(nw, b, n, c, heads, seed=n * 10 + b)
    want = TSA.swin_window_attention_bwd_plain(q, k, v, bias, do, heads)
    for groups in sorted({TSA.bwd_batch_groups(nw, b, heads, n), 1, b}):
        got = backward_mirror(q, k, v, bias, do, heads, groups, hilo=False)
        _close(got, want, f"{groups} groups")


@pytest.mark.parametrize("nw,b,n,c,heads", BWD_GEOMS)
def test_backward_mirror_with_hi_lo_weights_matches_split_plain(nw, b, n, c,
                                                               heads):
    """bf16's order: inputs rounded to bf16 on both sides, P and dS as hi +
    lo in dQ', dV and dK, against the plain version with `split_weights`
    (the mirror the card holds the bf16 #9 to) and, as hi + lo keeps
    ~2^-17 of a weight, against the unsplit one too."""
    q, k, v, bias, do = _train_inputs(nw, b, n, c, heads, seed=n + b + 1)
    q, k, v, do = (_bf16(x) for x in (q, k, v, do))
    got = backward_mirror(q, k, v, bias, do, heads,
                          TSA.bwd_batch_groups(nw, b, heads, n), hilo=True)
    _close(got, TSA.swin_window_attention_bwd_plain(
        q, k, v, bias, do, heads, split_weights=True), "split plain")
    _close(got, TSA.swin_window_attention_bwd_plain(q, k, v, bias, do, heads),
           "plain")
