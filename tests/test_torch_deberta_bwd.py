"""The DeBERTa disentangled-attention backward (#11) against the JAX
package: the port's plain backward `deberta_attention_bwd_plain`, and
autograd through the port's `deberta_attention` (the plain versions under
its autograd Function on the CPU), against jax.grad of
`_deberta_attn_trainable` (the Pallas forward and backward kernels in
interpret mode, as tests/test_deberta_bwd.py runs them), at the JAX test's
geometries, fp32, with a padded tail row and a row with no valid key.

Tolerance: 1e-5 of each gradient's largest |value| (fp32 sums in another
order); the reference is the fp32 math, which the Pallas backward
computes whatever LOWP_SCORES says (it rounds only bf16 forwards).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import deberta as JD
from mmd_tpu_torch.ops import deberta_attention as DA

REL = 1e-5
NAMES = ("dq", "dk", "dv", "dPK", "dPQ")


def _inputs(t, dim, seed):
    rng = np.random.default_rng(seed)
    b = 3
    arrs = [rng.standard_normal((b, t, dim)).astype(np.float32)
            for _ in range(3)]
    arrs += [rng.standard_normal((2 * t, dim)).astype(np.float32)
             for _ in range(2)]
    mask = np.ones((b, t), np.int32)
    mask[1, t - 11:] = 0                    # padded tail
    mask[2, :] = 0                          # no valid key: uniform P
    do = rng.standard_normal((b, t, dim)).astype(np.float32)
    return arrs, mask, do


def _jax_grads(arrs, mask, do, heads, scale):
    def f(q, k, v, pk, pq):
        return JD._deberta_attn_trainable(q, k, v, pk, pq, jnp.asarray(mask),
                                          heads, scale)
    out, vjp = jax.vjp(f, *map(jnp.asarray, arrs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, name):
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= REL * scale, (name, gap, scale)


@pytest.mark.parametrize("t,heads,dim", [(64, 2, 64), (128, 4, 128)])
def test_plain_backward_and_autograd_match_jax(t, heads, dim):
    arrs, mask, do = _inputs(t, dim, t + heads)
    scale = 1.0 / math.sqrt((dim // heads) * 3.0)
    jout, jgrads = _jax_grads(arrs, mask, do, heads, scale)

    tm = torch.from_numpy(mask)
    plain = DA.deberta_attention_bwd_plain(
        *map(torch.from_numpy, arrs), tm, torch.from_numpy(do), heads, scale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = DA.deberta_attention(*leaves, tm, heads, scale)
    _close(out.detach().numpy(), jout, "o")
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, p, a, w in zip(NAMES, plain, auto, jgrads):
        assert p.dtype == torch.float32 and p.shape == w.shape, name
        _close(p.numpy(), w, name)
        _close(a.numpy(), w, name)
    # the padded keys and the row with no valid key take no score gradient:
    # that row's dq is 0, as the reference's `where` makes it
    assert float(plain[0][2].abs().max()) == 0.0


# -- the Hopper kernel's decomposition (ops/csrc/deberta_attn_bwd.cu) ---------
# A tile-by-tile mirror of the index maps the kernel uses, in fp32 PyTorch:
# 64-row tile pairs; the position terms as products with 128-row bands of
# the tables; dS written skewed into a 64 x 128 matrix; each CTA's band
# gradients summed into its own (T + 64)-row slice; the slices summed in a
# fixed order (batch rows, then tiles). The dk/dv pass runs in the
# transposed frame (rows are keys), where the kernel uses the same code
# with K for Q, PQ for PK and the columns' softmax statistics.

TILE = 64


def _diag(g):
    """(64, 128) -> (64, 64): out[r, c] = g[r, 63 - r + c]."""
    r = torch.arange(TILE)[:, None]
    return g[r, TILE - 1 - r + torch.arange(TILE)[None, :]]


def _skew(ds):
    """(64, 64) -> (64, 128): out[r, 63 - r + c] = ds[r, c], 0 elsewhere."""
    out = torch.zeros(TILE, 2 * TILE)
    r = torch.arange(TILE)[:, None].expand(TILE, TILE)
    c = torch.arange(TILE)[None, :].expand(TILE, TILE)
    out[r, TILE - 1 - r + c] = ds
    return out


def _mirror_head(qh, kh, vh, doh, pkh, pqh, valid, scale):
    """One head, all batch rows -> (dq, dk, dv) (B, T, dh) and (dPK, dPQ)
    (2T, dh), computed as the kernel's grad passes compute them."""
    b, t, dh = qh.shape
    n = t // TILE
    neg = torch.finfo(torch.float32).min

    def tile(x, i):
        return x[i * TILE:(i + 1) * TILE]

    def band(tab, o, w):
        """The band of own tile o and walked tile w: table rows from
        T - 64 - 64 o + 64 w; local row 63 - r + c serves pair (r, c)."""
        base = t - TILE - TILE * o + TILE * w
        return tab[base:base + 2 * TILE]

    def scores(x, y, own_band, other_band):
        """A tile pair's scores in the frame whose rows are x's: content,
        the own term diag(x own_band^T), and the other term, y
        other_band^T read along the transposed diagonal."""
        return (x @ y.T + _diag(x @ own_band.T)
                + _diag(y @ other_band.T).T) * scale

    grads = {name: torch.zeros(b, t, dh) for name in ("dq", "dk", "dv")}
    slices = {name: torch.zeros(b, n, t + TILE, dh) for name in ("pk", "pq")}
    for bi in range(b):
        q, k, v, do, ok = qh[bi], kh[bi], vh[bi], doh[bi], valid[bi]
        # stats pass: each query row's max, sum and D over all key tiles
        s = torch.cat([torch.cat([scores(tile(q, o), tile(k, w),
                                         band(pkh, o, w), band(pqh, w, o))
                                  for w in range(n)], 1) for o in range(n)])
        s = s.masked_fill(~ok[None, :], neg)
        m = s.max(1, keepdim=True).values
        inv_l = 1.0 / torch.exp(s - m).sum(1, keepdim=True)
        dp = do @ v.T
        d_row = ((torch.exp(s - m) * inv_l) * dp).sum(1, keepdim=True)
        for o in range(n):          # dq pass: own query tile o
            for w in range(n):
                x, y = tile(q, o), tile(k, w)
                st = scores(x, y, band(pkh, o, w), band(pqh, w, o))
                st = st.masked_fill(~tile(ok, w)[None, :], neg)
                p = torch.exp(st - tile(m, o)) * tile(inv_l, o)
                ds = p * (tile(do, o) @ tile(v, w).T - tile(d_row, o)) * scale
                ds = ds.masked_fill(~tile(ok, w)[None, :], 0.0)
                dsk = _skew(ds)
                grads["dq"][bi, o * TILE:(o + 1) * TILE] += (
                    ds @ y + dsk @ band(pkh, o, w))
                slices["pk"][bi, o, w * TILE:w * TILE + 2 * TILE] += dsk.T @ x
        for o in range(n):          # dk/dv pass, transposed: own key tile o
            for w in range(n):
                x, y = tile(k, o), tile(q, w)
                st = scores(x, y, band(pqh, o, w), band(pkh, w, o))
                st = st.masked_fill(~tile(ok, o)[:, None], neg)
                pt = torch.exp(st - tile(m, w).T) * tile(inv_l, w).T
                dst = pt * (tile(v, o) @ tile(do, w).T
                            - tile(d_row, w).T) * scale
                dst = dst.masked_fill(~tile(ok, o)[:, None], 0.0)
                dskt = _skew(dst)
                grads["dv"][bi, o * TILE:(o + 1) * TILE] += pt @ tile(do, w)
                grads["dk"][bi, o * TILE:(o + 1) * TILE] += (
                    dst @ y + dskt @ band(pqh, o, w))
                slices["pq"][bi, o, w * TILE:w * TILE + 2 * TILE] += dskt.T @ x
    tables = []
    for name in ("pk", "pq"):       # the fixed-order sum: b, then tiles
        out = torch.zeros(2 * t, dh)
        for bi in range(b):
            for o in range(n):
                base = t - TILE - TILE * o  # the table row of slice row 0
                out[base:base + t + TILE] += slices[name][bi, o]
        tables.append(out)
    return grads["dq"], grads["dk"], grads["dv"], *tables


def _mirror(q, k, v, pk, pq, mask, do, heads, scale):
    """All heads of `_mirror_head`, merged back to (B, T, D) / (2T, D)."""
    valid = mask != 0
    outs = [_mirror_head(*(DA.split_heads(x, heads)[..., h, :, :]
                           for x in (q, k, v, do, pk, pq)), valid, scale)
            for h in range(heads)]
    return [torch.cat([o[i] for o in outs], -1) for i in range(5)]


@pytest.mark.parametrize("t,heads,dim", [(128, 2, 64), (256, 2, 64)])
def test_kernel_decomposition_matches_plain_and_jax(t, heads, dim):
    """The skewed-band algebra of the Hopper kernel, mirrored tile by tile,
    against the port's plain backward and JAX's grads of
    `_deberta_attn_trainable`, fp32, 1e-5 of each gradient's largest
    |value|; with a padded tail and a row with no valid key."""
    arrs, mask, do = _inputs(t, dim, 7 * t + heads)
    scale = 1.0 / math.sqrt((dim // heads) * 3.0)
    tm = torch.from_numpy(mask)
    got = _mirror(*map(torch.from_numpy, arrs), tm, torch.from_numpy(do),
                  heads, scale)
    plain = DA.deberta_attention_bwd_plain(
        *map(torch.from_numpy, arrs), tm, torch.from_numpy(do), heads, scale)
    _, jgrads = _jax_grads(arrs, mask, do, heads, scale)
    for name, g, p, w in zip(NAMES, got, plain, jgrads):
        assert g.shape == w.shape, name
        _close(g.numpy(), p.numpy(), name)
        _close(g.numpy(), w, name)
