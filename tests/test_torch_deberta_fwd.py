"""The Hopper DeBERTa attention forward's order of work
(mmd_tpu_torch/ops/csrc/deberta_attn_fwd.cu), mirrored in fp32 PyTorch and
held against the port's plain version `deberta_attention_plain` and the
JAX package's Pallas kernel `_deberta_attn_fused` (interpret mode, T <= 128,
as tests/test_torch_deberta.py runs it).

The mirror does what one CTA does for its 64-query tile: it fills two rings
of three 64-row table chunks (PK for c2p, PQ for p2c) in the kernel's
order, one new chunk of each a step; walks the 64-key tiles; computes each
warp's 16 rows against its 80-row window of the two bands and reads the
position terms back along the skewed diagonals; keeps an online softmax in
the exp2 domain; and, in bf16, rounds P to bf16 before P.V while taking the
row sum l from the fp32 p.

Tolerances: fp32 2e-5 against both (fp32 scores on all sides, sums in
another order). bf16 (inputs rounded to bf16 on all sides): against the
plain version on the same rounded inputs, 2^-8 of the largest |V| -- each
weight rounded to bf16 moves o by at most 2^-9 max|V| (l from the fp32 p),
the bf16 output by 2^-9 |o| more; against the JAX kernel 2e-2, as in
tests/test_torch_deberta.py, because the JAX kernel also rounds its scores
to bf16 (LOWP_SCORES), which the port does not.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import deberta as JD
from mmd_tpu_torch.ops import deberta_attention as DA

torch.set_num_threads(2)

TILE = 64                      # query rows of a CTA, keys of a walked tile
WARPS = 4                      # 16 query rows each
NEG = torch.finfo(torch.float32).min
LOG2E = 1.4426950408889634
FP32_TOL = 2e-5
JAX_BF16_TOL = 2e-2

_R = torch.arange(TILE)[:, None].expand(TILE, TILE)
_C = torch.arange(TILE)[None, :].expand(TILE, TILE)
# score (r, c): the own term at column 15 - r % 16 + c of row r's window,
# the other term at column 15 - c % 16 + r of the walked row c's window
_OWN_COL = 15 - _R % 16 + _C
_OTHER_COL = 15 - _C % 16 + _R


def _bf16(x):
    return x.bfloat16().float()


def _inputs(t, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((3, t, d)).astype(np.float32)
               for _ in range(3))
    pk, pq = (rng.standard_normal((2 * t, d)).astype(np.float32)
              for _ in range(2))
    mask = np.ones((3, t), np.int32)
    mask[1, t - t // 3 - 5:] = 0            # padded tail, inside a tile
    mask[2] = 0                             # no valid key at all
    return q, k, v, pk, pq, mask


def _chunk(tab, r0):
    """Rows r0 .. r0 + 63 of a (2T, dh) table as the kernel copies them:
    rows past the table's end zero."""
    assert r0 >= 0
    out = torch.zeros(TILE, tab.shape[1])
    rows = tab[r0:r0 + TILE]
    out[:len(rows)] = rows
    return out


def _windows(a, band):
    """(64, dh) rows against each warp's window of a (128, dh) band ->
    (64, 80): the rows of warp w times band rows [48 - 16 w, 128 - 16 w)."""
    return torch.cat([a[16 * w:16 * w + 16] @ band[48 - 16 * w:128 - 16 * w].T
                      for w in range(WARPS)])


def _tile_scores(x, y, own_band, other_band):
    """The unscaled scores of the query tile x against the key tile y:
    content, c2p from x's windows of the PK band, p2c from y's windows of
    the PQ band (written by the walked rows' warps, read transposed)."""
    g_own = _windows(x, own_band)
    g_other = _windows(y, other_band)
    return x @ y.T + g_own[_R, _OWN_COL] + g_other[_C, _OTHER_COL]


def _mirror_head(q, k, v, pk, pq, valid, scale, lowp):
    """One head of one batch row as the kernel's CTAs compute it: q, k, v
    (T, dh), pk, pq (2T, dh), valid (T,) bool -> o (T, dh) fp32."""
    t = q.shape[0]
    n = t // TILE
    out = torch.empty_like(q)
    for o in range(n):                      # one CTA: query tile o
        ring_own, ring_other = [None] * 3, [None] * 3

        def load_own(c):                    # table rows T-64-64 o+64 c
            ring_own[c % 3] = _chunk(pk, t - TILE - TILE * o + TILE * c)

        def load_other(c):                  # table rows T-64+64 o-64 c
            ring_other[(c + 1) % 3] = _chunk(pq, t - TILE + TILE * o - TILE * c)

        load_own(0)
        load_own(1)
        load_other(-1)
        load_other(0)
        x = q[o * TILE:(o + 1) * TILE]
        m = torch.full((TILE, 1), -math.inf)
        l_sum = torch.zeros(TILE, 1)
        acc = torch.zeros(TILE, q.shape[1])
        for i in range(n):
            if i + 1 < n:                   # the next step's chunks, one each
                load_own(i + 2)
                load_other(i + 1)
            keys = slice(i * TILE, (i + 1) * TILE)
            own_band = torch.cat([ring_own[i % 3], ring_own[(i + 1) % 3]])
            other_band = torch.cat([ring_other[(i + 1) % 3],
                                    ring_other[i % 3]])
            s = _tile_scores(x, k[keys], own_band, other_band)
            s = torch.where(valid[keys][None, :], s * (scale * LOG2E),
                            torch.tensor(NEG))
            m_new = torch.maximum(m, s.max(1, keepdim=True).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l_sum = l_sum * alpha + p.sum(1, keepdim=True)
            acc = acc * alpha + (_bf16(p) if lowp else p) @ v[keys]
            m = m_new
        out[o * TILE:(o + 1) * TILE] = acc / l_sum
    return out


def _mirror(q, k, v, pk, pq, mask, heads, scale, lowp):
    """All batch rows and heads of `_mirror_head`, merged to (B, T, D)."""
    qh, kh, vh = (DA.split_heads(x, heads) for x in (q, k, v))
    pkh, pqh = DA.split_heads(pk, heads), DA.split_heads(pq, heads)
    valid = mask != 0
    out = torch.stack([torch.stack([
        _mirror_head(qh[b, h], kh[b, h], vh[b, h], pkh[h], pqh[h], valid[b],
                     scale, lowp) for h in range(heads)])
        for b in range(q.shape[0])])
    return out.transpose(1, 2).reshape(q.shape)


@pytest.mark.parametrize("t,heads,d", [
    (64, 2, 64), (64, 1, 64), (128, 4, 128), (128, 2, 128), (256, 2, 128),
    (192, 6, 192)])
def test_kernel_order_of_work_matches_plain_and_jax(t, heads, d):
    """Head dims 32 and 64; T 64 to 256 (one to four key tiles, all the
    ring's slots); a padded tail ending inside a tile and a row with no
    valid key."""
    arrs = _inputs(t, d, seed=t + heads)
    scale = 1.0 / math.sqrt(3.0 * d // heads)
    q, k, v, pk, pq, mask = map(torch.from_numpy, arrs)
    with_jax = t <= 128

    got = _mirror(q, k, v, pk, pq, mask, heads, scale, lowp=False)
    plain = DA.deberta_attention_plain(q, k, v, pk, pq, mask, heads, scale)
    torch.testing.assert_close(got, plain, rtol=0, atol=FP32_TOL)
    torch.testing.assert_close(got[2], v[2].mean(0).expand(t, d), rtol=0,
                               atol=FP32_TOL)
    if with_jax:
        want = np.asarray(JD._deberta_attn_fused(
            *map(jnp.asarray, arrs), heads, scale))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_TOL)

    # bf16: the same rounded inputs everywhere
    r16 = [_bf16(x) for x in (q, k, v, pk, pq)]
    unrounded = _mirror(*r16, mask, heads, scale, lowp=False)
    rounded = _mirror(*r16, mask, heads, scale, lowp=True)
    assert not torch.equal(rounded, unrounded)      # P was rounded
    got16 = _bf16(rounded)                          # the kernel's bf16 o
    plain16 = DA.deberta_attention_plain(*r16, mask, heads, scale)
    tol16 = 2.0 ** -8 * float(r16[2].abs().max())
    torch.testing.assert_close(got16, plain16, rtol=0, atol=tol16)
    if with_jax:
        want16 = JD._deberta_attn_fused(
            *(jnp.asarray(a, jnp.bfloat16) for a in arrs[:5]),
            jnp.asarray(arrs[5]), heads, scale)
        np.testing.assert_allclose(got16.numpy(),
                                   np.asarray(want16.astype(jnp.float32)),
                                   rtol=0, atol=JAX_BF16_TOL)
