"""The port's DeBERTa-v3 encoder (mmd_tpu_torch/models/deberta.py) and its
disentangled-attention op (mmd_tpu_torch/ops/deberta_attention.py) against
the JAX package.

The op's plain version, which the CUDA kernel is held to on the card, is
compared with the JAX package's Pallas kernel `_deberta_attn_fused` in
interpret mode (T <= 128: interpret mode crashes LLVM near T = 192). JAX on
the CPU never routes to that kernel (its gate asks for a TPU), so the
kernel path is reached through `deberta_layer(..., use_fused=True)`.
The PK and PQ tables and the q/k projections always differ, so a swap of
c2p and p2c cannot pass.

Tolerances: kernel level 2e-5 in fp32 (fp32 scores on both sides); models
1e-4 in fp32 (a few layers of fp32 matmuls summed in another order); the
one bf16 case 2e-2, one bf16 step at |o| ~ 1-2, because both sides round
the inputs and the output to bf16 and the JAX kernel also rounds its
scores to bf16 (LOWP_SCORES), which the port does not.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import deberta as JD
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.ops import deberta_attention as DA

torch.set_num_threads(2)

KTOL = dict(rtol=0, atol=2e-5)
MTOL = dict(rtol=1e-4, atol=1e-4)
# hidden 128 and T 64 pass the kernel gate (D and 2T multiples of 128)
GATE_CFG = JD.DebertaConfig(vocab_size=128, hidden_size=128, num_layers=2,
                            num_heads=2, intermediate_size=256,
                            max_position=64, position_buckets=16)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _kernel_inputs(t, d, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((3, t, d)).astype(np.float32)
               for _ in range(3))
    pk, pq = (rng.standard_normal((2 * t, d)).astype(np.float32)
              for _ in range(2))
    mask = np.ones((3, t), np.int32)
    mask[1, t - t // 3:] = 0                  # padded tail
    mask[2] = 0                               # no valid key at all
    return q, k, v, pk, pq, mask


@pytest.mark.parametrize("t,heads,d", [(64, 2, 64), (128, 4, 128)])
def test_attention_plain_matches_pallas_kernel(t, heads, d):
    q, k, v, pk, pq, mask = _kernel_inputs(t, d)
    scale = 1.0 / math.sqrt(3.0 * d // heads)
    want = np.asarray(JD._deberta_attn_fused(
        *map(jnp.asarray, (q, k, v, pk, pq, mask)), heads, scale))
    got = DA.deberta_attention(*map(torch.from_numpy, (q, k, v, pk, pq,
                                                       mask)),
                               heads, scale).numpy()
    np.testing.assert_allclose(got, want, **KTOL)
    # the row with no valid key is the uniform mean of V, per head
    np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(0), (t, d)),
                               rtol=0, atol=1e-5)
    # padded query rows are computed like any other, not zeroed
    assert np.abs(got[1, -1]).max() > 0


def test_attention_plain_bf16_matches_pallas_kernel():
    t, heads, d = 64, 2, 64
    arrs = _kernel_inputs(t, d, seed=1)
    scale = 1.0 / math.sqrt(3.0 * d // heads)
    want = JD._deberta_attn_fused(
        *(jnp.asarray(a, jnp.bfloat16) for a in arrs[:5]),
        jnp.asarray(arrs[5]), heads, scale)
    got = DA.deberta_attention(
        *(torch.from_numpy(a).bfloat16() for a in arrs[:5]),
        torch.from_numpy(arrs[5]), heads, scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def test_attention_gathers_match_oracle_index():
    """c2p reads PK at T-1-t+s and p2c reads PQ at T-1-s+t: a key-only
    PK (PQ zero) and a query-only PQ (PK zero) each move the scores as the
    reference's diagonal maps say."""
    t, d, heads = 8, 32, 1
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, t, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, t, d)).astype(np.float32))
    v = torch.eye(t, d)[None]                 # o[t] = softmax row t
    pk = torch.from_numpy(rng.standard_normal((2 * t, d)).astype(np.float32))
    zero = torch.zeros(2 * t, d)
    for tab_k, tab_q in ((pk, zero), (zero, pk)):
        p = DA.deberta_attention_plain(q, k, v, tab_k, tab_q, None, heads,
                                       1.0)[0, :, :t]
        s = q[0] @ k[0].T
        for ti in range(t):
            for si in range(t):
                s[ti, si] += (q[0, ti] @ tab_k[t - 1 - ti + si]
                              + k[0, si] @ tab_q[t - 1 - si + ti])
        torch.testing.assert_close(p, torch.softmax(s, -1), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("use_fused", [False, True])
def test_deberta_layer_matches_jax(use_fused):
    jcfg = GATE_CFG
    tree = _np_tree(JD.init_deberta(jax.random.key(5), jcfg))
    tcfg = TD.DebertaConfig(**dataclasses.asdict(jcfg))
    params = bridge.deberta_from_jax(tree, tcfg)
    rng = np.random.default_rng(6)
    t = 64
    x = rng.standard_normal((2, t, jcfg.hidden_size)).astype(np.float32)
    rel = rng.standard_normal((2 * jcfg.pos_ebd_size,
                               jcfg.hidden_size)).astype(np.float32)
    mask = np.ones((2, t), np.int32)
    mask[1, 50:] = 0
    c2p, p2c = JD._diag_maps(t, jcfg)
    want = JD.deberta_layer(tree["layers"][0], jcfg, jnp.asarray(x),
                            jnp.asarray(rel), c2p, p2c, jnp.asarray(mask),
                            jnp.float32, use_fused)
    with torch.no_grad():
        got = TD.deberta_layer(params["layers"][0], tcfg, torch.from_numpy(x),
                               torch.from_numpy(rel), c2p, p2c,
                               torch.from_numpy(mask), torch.float32,
                               use_fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MTOL)


@pytest.mark.parametrize("name", ["DEBERTA_TEST", "gate"])
def test_deberta_encode_matches_jax(name):
    jcfg = JD.DEBERTA_TEST if name == "DEBERTA_TEST" else GATE_CFG
    tree = _np_tree(JD.init_deberta(jax.random.key(2), jcfg))
    tcfg = TD.DebertaConfig(**dataclasses.asdict(jcfg))
    params = bridge.deberta_from_jax(tree, tcfg)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, jcfg.vocab_size, (3, 64)).astype(np.int32)
    mask = np.ones((3, 64), np.int32)
    mask[1, 40:] = 0
    mask[2, 5:] = 0
    want = JD.deberta_encode(tree, jcfg, ids, mask)
    with torch.no_grad():
        got = TD.deberta_encode(params, tcfg, torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MTOL)


@pytest.mark.parametrize("port_name,jax_name", [
    ("make_log_bucket_position", "make_log_bucket_position"),
    ("build_relative_position", "build_relative_position"),
    ("_diag_maps", "_diag_maps")])
def test_static_tables_match_jax(port_name, jax_name):
    if port_name == "_diag_maps":
        for t in (8, 64, 512):
            for cfg in (JD.DEBERTA_TEST, JD.DEBERTA_V3_XSMALL):
                for a, b in zip(TD._diag_maps(t, TD.DebertaConfig(
                        **dataclasses.asdict(cfg))), JD._diag_maps(t, cfg)):
                    np.testing.assert_array_equal(a, b)
    elif port_name == "build_relative_position":
        np.testing.assert_array_equal(
            TD.build_relative_position(40, 33, 16, 64),
            JD.build_relative_position(40, 33, 16, 64))
    else:
        rel = np.arange(-600, 600)
        np.testing.assert_array_equal(
            TD.make_log_bucket_position(rel, 256, 512),
            JD.make_log_bucket_position(rel, 256, 512))


def test_use_fused_attn_gate():
    cfg = TD.DebertaConfig(**dataclasses.asdict(GATE_CFG))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TD.use_fused_attn(cfg, 64, cuda)
    assert TD.use_fused_attn(TD.DEBERTA_V3_XSMALL, 512, cuda)
    assert not TD.use_fused_attn(cfg, 64, cpu)
    assert not TD.use_fused_attn(cfg, 48, cuda)          # 2T % 128 != 0
    assert not TD.use_fused_attn(TD.DEBERTA_TEST, 64, cuda)  # D % 128 != 0
    assert not TD.use_fused_attn(dataclasses.replace(cfg, fused_attn=False),
                                 64, cuda)


def test_remat_raises():
    """remat runs now: the same output and a gradient that reaches the
    params; what still raises is the attention op on a device that is
    neither cpu nor cuda."""
    cfg = dataclasses.replace(TD.DEBERTA_TEST, remat=True)
    params = TD.init_deberta(torch.Generator().manual_seed(0), cfg)
    ids = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    want = TD.deberta_encode(params, TD.DEBERTA_TEST, ids)
    got = TD.deberta_encode(params, cfg, ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    got.square().sum().backward()
    assert params["rel_embeddings"].grad is not None
    x = torch.zeros(1, 64, 64, device="meta")
    tab = torch.zeros(128, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        TD.deberta_attention(x, x, x, tab, tab, None, 2, 0.1)


def test_kernel_path_hands_the_op_contiguous_tensors(monkeypatch):
    """The kernel path passes the op what the CUDA kernel requires:
    contiguous (B, T, D) q/k/v and (2T, D) tables, once per layer."""
    tcfg = TD.DebertaConfig(**dataclasses.asdict(GATE_CFG))
    params = TD.init_deberta(torch.Generator().manual_seed(0), tcfg)
    op, calls = TD.deberta_attention, []

    def check(q, k, v, pk, pq, mask, heads, scale):
        calls.append(1)
        assert all(t.is_contiguous() for t in (q, k, v, pk, pq))
        assert pk.shape == pq.shape == (2 * q.shape[1], q.shape[2])
        return op(q, k, v, pk, pq, mask, heads, scale)

    monkeypatch.setattr(TD, "deberta_attention", check)
    monkeypatch.setattr(TD, "use_fused_attn", lambda *a: True)
    with torch.no_grad():
        TD.deberta_encode(params, tcfg, torch.zeros(2, 64, dtype=torch.long),
                          torch.ones(2, 64, dtype=torch.int32))
    assert len(calls) == tcfg.num_layers
