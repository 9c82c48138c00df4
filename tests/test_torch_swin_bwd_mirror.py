"""The Hopper Swin fine-tuning backward's order of work
(mmd_tpu_torch/ops/csrc/swin_window_attn_train.cu, swin_train_bwd_kernel),
mirrored in fp32 PyTorch and held against the port's plain version
`swin_window_attention_bwd_plain` and jax.vjp of the JAX package's
`swin_window_attention` (its Pallas kernels in interpret mode, as
tests/test_torch_swin_bwd.py runs them).

The mirror does what one CTA does for its (window, head, group of batch
rows): it walks the group's rows in order; on the query side each of the 4
warps takes its 16 query rows to P, dS and dQ' = dS K, adds dS into the
CTA's dbias and puts P and dS into the weight tiles; on the key side each
warp takes its 16 keys and reads the tiles transposed for dV = P^T dO and
dK = dS^T Q'. In bf16 every weight goes into its product as bf16 hi + bf16
lo. dbias is each CTA's sum over its rows, then the groups' sum in their
order (the workspace and swin_train_dbias_kernel).

Tolerances: fp32 within 1e-5 of each gradient's largest |value| (sums in
another order; the Pallas kernel packs g = 128 / dh heads into one
product). With the hi + lo split, on inputs rounded to bf16 on both sides,
the same 1e-5: each weight keeps ~2^-17 (7.6e-6) of itself.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import swin_attention as JSA
from mmd_tpu_torch.ops import swin_attention as TSA

torch.set_num_threads(2)

N = 64                         # tokens a window
WARPS = 4                      # 16 rows (queries, then keys) each
LN2 = 0.6931471805599453
LOG2E = 1.4426950408889634
REL = 1e-5


def _bf16(x):
    return x.bfloat16().float()


def _split(w, hilo):
    """A weight tile as the kernel feeds it to a product: bf16 hi + bf16 lo
    (what rounding to bf16 left, rounded to bf16 itself), or as it is."""
    if not hilo:
        return w
    hi = _bf16(w)
    return hi + _bf16(w - hi)


def _cta(q, k, v, do, bias, hilo):
    """One CTA: q, k, v, do (rows, 64, dh) of its batch rows, bias (64, 64)
    -> dq, dk, dv (rows, 64, dh) and the CTA's dbias (64, 64)."""
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    db = torch.zeros(N, N)
    for i in range(q.shape[0]):               # the group's rows, in order
        wp, wds = torch.zeros(N, N), torch.zeros(N, N)   # the weight tiles
        for w in range(WARPS):                # query side
            rows = slice(16 * w, 16 * w + 16)
            s = q[i, rows] @ k[i].T + bias[rows]
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp2(s - m)
            p = p * (1.0 / p.sum(dim=-1, keepdim=True).clamp_min(1e-37))
            dp = do[i, rows] @ v[i].T
            d = (p * dp).sum(dim=-1, keepdim=True)
            ds = LN2 * p * (dp - d)
            db[rows] += ds
            dq[i, rows] = _split(ds, hilo) @ k[i]
            wp[rows], wds[rows] = p, ds
        for w in range(WARPS):                # key side, the tiles transposed
            keys = slice(16 * w, 16 * w + 16)
            dv[i, keys] = _split(wp[:, keys], hilo).T @ do[i]
            dk[i, keys] = _split(wds[:, keys], hilo).T @ q[i]
    return dq, dk, dv, db


def mirror(q, k, v, bias, do, heads, groups, hilo):
    """The kernel's grid: (head, window, group) CTAs over (nW, B, 64, C)
    inputs -> dq, dk, dv (nW, B, 64, C) and dbias (nW, heads, 64, 64)."""
    nw, b, n, c = q.shape
    dh = c // heads
    per = b // groups
    out = [torch.zeros(nw, b, n, c) for _ in range(3)]
    dbias = torch.zeros(nw, heads, n, n)
    for w in range(nw):
        for h in range(heads):
            cols = slice(h * dh, (h + 1) * dh)
            parts = []
            for grp in range(groups):
                rows = slice(grp * per, (grp + 1) * per)
                tiles = (x[w, rows, :, cols] for x in (q, k, v, do))
                *grads, db = _cta(*tiles, bias[w, h], hilo)
                for o, g in zip(out, grads):
                    o[w, rows, :, cols] = g
                parts.append(db)
            acc = parts[0]                    # the groups' sum, in order
            for part in parts[1:]:
                acc = acc + part
            dbias[w, h] = acc
    return (*out, dbias)


def _inputs(nw, b, c, heads, seed):
    rng = np.random.default_rng(seed)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, b, N, heads, dh)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(
            nw, b, N, c).astype(np.float32)

    q = unit(rng.standard_normal((nw, b, N, c))) * np.float32(10 * LOG2E)
    k = unit(rng.standard_normal((nw, b, N, c)))
    v = rng.standard_normal((nw, b, N, c)).astype(np.float32)
    do = rng.standard_normal((nw, b, N, c)).astype(np.float32)
    # position bias in (0, 16) plus a -100 region mask twice, log2 domain
    bias = ((16 * rng.random((nw, heads, N, N))
             - 200 * (rng.random((nw, 1, N, N)) < 0.3)) * LOG2E
            ).astype(np.float32)
    return q, k, v, bias, do


def _close(got, want, what):
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        w = np.asarray(w)
        assert tuple(a.shape) == w.shape, (what, name)
        gap = float(np.abs(a.numpy() - w).max())
        assert gap <= REL * float(np.abs(w).max()), (what, name, gap)


# (nW, B, C, heads): head dim 32 with a batch row a group and with several,
# B 7 (prime: one group or seven), head dim 64
GEOMS = [(2, 4, 128, 4), (1, 7, 64, 2), (2, 3, 128, 2)]


@pytest.mark.parametrize("nw,b,c,heads", GEOMS)
def test_mirror_matches_plain_and_jax(nw, b, c, heads):
    """fp32: the mirror at the wrapper's batch split and at one group (one
    CTA walks every row and writes dbias itself) against the plain version
    and the JAX package's Pallas backward."""
    q, k, v, bias, do = _inputs(nw, b, c, heads, seed=nw * 100 + b + c)
    _, vjp = jax.vjp(functools.partial(JSA.swin_window_attention,
                                       heads=heads),
                     *map(jnp.asarray, (q, k, v, bias)))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    t = [torch.from_numpy(x) for x in (q, k, v, bias, do)]
    plain = [x.numpy() for x in TSA.swin_window_attention_bwd_plain(
        *t, heads)]
    for groups in sorted({TSA.bwd_batch_groups(nw, b, heads), 1}):
        got = mirror(*t, heads, groups, hilo=False)
        _close(got, plain, f"plain, {groups} groups")
        _close(got, jgrads, f"jax, {groups} groups")


@pytest.mark.parametrize("nw,b,c,heads", GEOMS)
def test_mirror_with_hi_lo_weights_matches_plain(nw, b, c, heads):
    """bf16's order of work: inputs rounded to bf16 on both sides (exact as
    the kernel's bf16 operands), P and dS as hi + lo in dQ', dV and dK;
    the groups as the wrapper splits them."""
    q, k, v, bias, do = _inputs(nw, b, c, heads, seed=nw * 10 + b)
    t = [_bf16(torch.from_numpy(x)) for x in (q, k, v, do)]
    tb = torch.from_numpy(bias)
    want = [x.numpy() for x in TSA.swin_window_attention_bwd_plain(
        t[0], t[1], t[2], tb, t[3], heads)]
    got = mirror(t[0], t[1], t[2], tb, t[3], heads,
                 TSA.bwd_batch_groups(nw, b, heads), hilo=True)
    _close(got, want, "hi + lo")
