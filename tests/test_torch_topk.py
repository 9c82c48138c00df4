"""The port's dense retrieval ops (mmd_tpu_torch/ops/topk.py) against the
JAX package's (mmd_tpu/ops/topk.py), on the CPU.

Tolerances: indices equal; fp32 scores within 1e-6 of the largest |score|
(summation order only: the norm and the product are summed in another
order, so a normalized row differs from JAX's by 3e-7 relative); int8
codes and scales bit-identical on the same fp32 rows. Ties follow
`lax.top_k`: the lower index first, and the lower index kept at the k-th
place (`torch.topk` itself gives no such order: CPU and CUDA differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import topk as J
from mmd_tpu_torch.ops import topk as T

torch.set_num_threads(2)


def _data(seed, q, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def test_l2_normalize_matches_jax():
    """The norm may differ from XLA's by one ulp (summation order): each
    element within 3e-7 relative."""
    _, x = _data(0, 1, 500, 256)
    got = T.l2_normalize(torch.from_numpy(x)).numpy()
    want = np.asarray(J.l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert T.l2_normalize(torch.from_numpy(x).bfloat16()).dtype \
        == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("normalize", [True, False], ids=["cosine", "dot"])
def test_dense_topk_matches_jax(normalize, dtype):
    q, c = _data(1, 5, 300, 64)
    js, ji = J.dense_topk(jnp.asarray(q, dtype), jnp.asarray(c, dtype), 10,
                          normalize)
    ts, ti = T.dense_topk(torch.from_numpy(q).to(getattr(torch, dtype)),
                          torch.from_numpy(c).to(getattr(torch, dtype)), 10,
                          normalize)
    assert ts.dtype == torch.float32 and ts.shape == (5, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    js = np.asarray(js)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0,
                               atol=1e-6 * np.abs(js).max())


def test_quantize_rows_int8_bit_identical_to_jax():
    """Same fp32 rows (JAX's normalized ones): codes and scales equal bit
    for bit -- round half to even, the clip at +-127, the 1e-12 floor."""
    _, c = _data(2, 1, 400, 96)
    c[3] = 0.0                                   # the floor
    c[5, :4] = [0.5, -0.5, 1.5, 2.5]             # ties to even at scale 1
    c[5, 4:] = 0.0
    c[5, 4] = 127.0
    x = np.array(J.l2_normalize(jnp.asarray(c)))
    x[5] = c[5]
    jq, js = J.quantize_rows_int8(jnp.asarray(x))
    tq, ts = T.quantize_rows_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq[5, :4].numpy(), [0, 0, 2, 2])


@pytest.mark.parametrize("q_rows", [1, 5, 64])
def test_dense_topk_int8_matches_jax(q_rows):
    """JAX's int8 corpus (codes and scales) and queries: the same indices,
    scores within 1e-6 (the query's norm, within one ulp, may move its
    scale by one ulp)."""
    q, c = _data(3, q_rows, 500, 64)
    c8, cs = J.quantize_rows_int8(J.l2_normalize(jnp.asarray(c)))
    js, ji = J.dense_topk_int8(jnp.asarray(q), c8, cs, 10)
    ts, ti = T.dense_topk_int8(torch.from_numpy(q),
                               torch.from_numpy(np.array(c8)),
                               torch.from_numpy(np.array(cs)), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


@pytest.mark.parametrize("q,n,d", [(1, 6, 32), (3, 16, 20), (9, 17, 8),
                                   (2, 40, 13)])
def test_int8_products_pad_for_int_mm(q, n, d):
    """The padded product (corpus rows first, queries padded to a multiple
    of 8, a corpus of <= 16 rows to 24, D to a multiple of 8) is the int32
    product itself."""
    rng = np.random.default_rng(q * 100 + n)
    a = torch.from_numpy(rng.integers(-127, 128, (q, d)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
    got = T.int8_products(a, b)
    assert got.dtype == torch.int32 and got.shape == (q, n)
    np.testing.assert_array_equal(
        got.numpy(), a.numpy().astype(np.int32) @ b.numpy().astype(np.int32).T)


def test_topk_lower_index_first_is_lax_top_k():
    """Integer-valued scores with many ties, negatives and zeros of both
    signs: values and indices equal lax.top_k's."""
    rng = np.random.default_rng(4)
    s = rng.integers(-3, 4, (6, 50)).astype(np.float32)
    s[0, :5] = [0.0, -0.0, 0.0, -0.0, 3.0]
    for k in (1, 7, 50):
        jv, ji = jax.lax.top_k(jnp.asarray(s), k)
        tv, ti = T.topk_lower_index_first(torch.from_numpy(s), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v, i = T.topk_lower_index_first(torch.tensor([[1., 3, 3, 2, 3]]), 2)
    assert i.tolist() == [[1, 2]]


@pytest.mark.parametrize("path", ["bf16", "int8"])
def test_duplicate_rows_come_back_lower_index_first(path):
    """Duplicated corpus rows score exactly alike: the lower index comes
    first (as in JAX), and exact_score_dedup keeps it."""
    q, c = _data(5, 1, 64, 128)
    c[20] = c[7]
    c[33] = c[7]
    q[0] = c[7] + 0.001 * q[0]
    if path == "bf16":
        js, ji = J.dense_topk(jnp.asarray(q, jnp.bfloat16),
                              jnp.asarray(c, jnp.bfloat16), 5)
        ts, ti = T.dense_topk(torch.from_numpy(q).bfloat16(),
                              torch.from_numpy(c).bfloat16(), 5)
    else:
        c8, cs = J.quantize_rows_int8(J.l2_normalize(jnp.asarray(c)))
        js, ji = J.dense_topk_int8(jnp.asarray(q), c8, cs, 5)
        ts, ti = T.dense_topk_int8(torch.from_numpy(q),
                                   torch.from_numpy(np.array(c8)),
                                   torch.from_numpy(np.array(cs)), 5)
    assert ti[0, :3].tolist() == [7, 20, 33] == np.asarray(ji)[0, :3].tolist()
    assert ts[0, 0] == ts[0, 1] == ts[0, 2]
    ds, di = T.exact_score_dedup(ts[0].numpy(), ti[0].numpy(), 5)
    assert di[0] == 7 and 20 not in di and 33 not in di
    jds, jdi = J.exact_score_dedup(np.asarray(js)[0], np.asarray(ji)[0], 5)
    assert di == jdi
    np.testing.assert_allclose(ds, jds, rtol=0, atol=1e-6)


def test_exact_score_dedup_matches_jax():
    rng = np.random.default_rng(6)
    s = np.round(rng.random(40), 1)
    i = rng.permutation(40)
    for k in (1, 3, 10, 40):
        assert T.exact_score_dedup(s, i, k) == J.exact_score_dedup(s, i, k)


def test_int8_topk_top1_and_recall():
    """tests/test_topk.py's bar on the port: planted top-1 for 16 noisy
    copies of corpus rows; recall@10 against the bf16 path >= 0.9."""
    rng = np.random.default_rng(7)
    n, d, k = 1000, 256, 10
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    picks = rng.integers(0, n, 16)
    queries = corpus[picks] + 0.01 * rng.standard_normal((16, d))
    c = torch.from_numpy(corpus)
    q8, sc = T.quantize_rows_int8(T.l2_normalize(c))
    _, i8 = T.dense_topk_int8(torch.from_numpy(queries).float(), q8, sc, k)
    _, ib = T.dense_topk(torch.from_numpy(queries).bfloat16(), c.bfloat16(),
                         k)
    np.testing.assert_array_equal(i8[:, 0].numpy(), picks)
    recall = np.mean([len(set(a) & set(b)) / k
                      for a, b in zip(i8.tolist(), ib.tolist())])
    assert recall >= 0.9, recall
