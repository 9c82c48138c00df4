"""Port attention (mmd_tpu_torch/ops/attention.py) against the JAX package.

The same numpy inputs go through JAX's multi_head_attention — fused=True
reaches the Pallas flash kernel, in interpret mode on the CPU, and
fused=False the jnp path — and through the port. On the CPU the port's
flash_attention runs its plain version, flash_attention_plain. Tolerance:
fp32 atol/rtol 2e-5, as tests/test_attention.py holds the Pallas kernel to
the jnp path. A key mask with one fully-masked batch row checks both
behaviours: zeros on the kernel side, a uniform softmax on the explicit
side. The CUDA kernel itself is checked against the plain version in
tests/test_torch_cuda.py, which needs a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import attention as jattn
from mmd_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
GEOMETRIES = [(64, 64), (512, 64), (64, 512), (16, 40)]
B, H = 3, 2


def _inputs(t, s, dh, masked, seed=0):
    rng = np.random.default_rng(seed)
    d = H * dh
    q = rng.standard_normal((B, t, d)).astype(np.float32)
    k = rng.standard_normal((B, s, d)).astype(np.float32)
    v = rng.standard_normal((B, s, d)).astype(np.float32)
    mask = None
    if masked:
        mask = np.ones((B, s), np.float32)
        mask[1, s // 2 + 1:] = 0.0          # a padded row
        mask[2] = 0.0                       # a row with no valid key
    return q, k, v, mask


def _jax(q, k, v, mask, fused):
    return np.asarray(jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, fused=fused,
        key_mask=None if mask is None else jnp.asarray(mask)))


def _t(x):
    return None if x is None else torch.from_numpy(x)


cases = pytest.mark.parametrize("t,s", GEOMETRIES)
dims = pytest.mark.parametrize("dh", [32, 64])
masks = pytest.mark.parametrize("masked", [False, True])


@cases
@dims
@masks
def test_fused_matches_pallas(t, s, dh, masked):
    q, k, v, mask = _inputs(t, s, dh, masked)
    want = _jax(q, k, v, mask, fused=True)
    got = tattn.multi_head_attention(_t(q), _t(k), _t(v), H, fused=True,
                                     key_mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if masked:
        assert np.all(got[2] == 0.0) and np.all(want[2] == 0.0)


@cases
@dims
@masks
def test_explicit_matches_jnp(t, s, dh, masked):
    q, k, v, mask = _inputs(t, s, dh, masked)
    want = _jax(q, k, v, mask, fused=False)
    got = tattn.multi_head_attention(_t(q), _t(k), _t(v), H, fused=False,
                                     key_mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if masked:       # the -1e9 bias turns a row with no valid key uniform
        np.testing.assert_allclose(
            got[2], np.broadcast_to(v[2].mean(0), got[2].shape), **TOL)


@cases
@dims
@masks
def test_plain_lse_matches_flash_fwd(t, s, dh, masked):
    """flash_attention_plain's (o, natural-log lse) against _flash_fwd's
    (o, log2 lse); lse only where the row has a valid key (JAX keeps a
    finite sentinel there, the port -inf)."""
    q, k, v, mask = _inputs(t, s, dh, masked)
    kb = None if mask is None else jnp.asarray((1.0 - mask) * -1e9)
    o_j, lse2 = jattn._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.zeros((1,), jnp.int32),
                                 H, 0.0, kb=kb)
    o, lse = tattn.flash_attention_plain(_t(q), _t(k), _t(v), H, _t(mask))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    want = np.asarray(lse2) * math.log(2.0)
    rows = slice(0, 2) if masked else slice(None)
    np.testing.assert_allclose(lse.numpy()[rows], want[rows], **TOL)
    if masked:
        assert np.all(np.isneginf(lse.numpy()[2]))


def test_flash_attention_dispatches_cpu_to_plain():
    q, k, v, mask = _inputs(16, 40, 32, True)
    before = tattn.launches
    o, lse = tattn.flash_attention(_t(q), _t(k), _t(v), H, _t(mask))
    o_p, lse_p = tattn.flash_attention_plain(_t(q), _t(k), _t(v), H, _t(mask))
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert tattn.launches == before         # no kernel ran


def test_small_head_dim_takes_explicit_path():
    """dh < 32 never reaches the kernel (JAX routes it to XLA too)."""
    q, k, v, mask = _inputs(16, 40, 8, True)
    fused = tattn.multi_head_attention(_t(q), _t(k), _t(v), H, fused=True,
                                       key_mask=_t(mask))
    explicit = tattn.multi_head_attention(_t(q), _t(k), _t(v), H,
                                          fused=False, key_mask=_t(mask))
    assert torch.equal(fused, explicit)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "layout", "mask"])
def test_kernel_input_checks_raise(bad):
    q, k, v, mask = (_t(x) for x in _inputs(16, 40, 32, True))
    heads = H
    if bad == "head_dim":
        heads = 4                            # dh = 16
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "layout":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        mask = mask[:, :-1]
    with pytest.raises(ValueError):
        tattn._check_kernel_inputs(q, k, v, heads, mask)


def test_dropout_raises():
    """Attention dropout without a seed raises, as JAX's does without an
    rng."""
    q, k, v, _ = (_t(x) for x in _inputs(16, 40, 32, False))
    with pytest.raises(ValueError, match="seed"):
        tattn.multi_head_attention(q, k, v, H, dropout_rate=0.1,
                                   deterministic=False)


# -- training: attention dropout and the backward ----------------------------
# The TPU PRNG behind the JAX package's attention dropout has no interpret
# mode, so JAX is compared with the port at rate 0 only; with dropout the
# port's paths are held against each other on one seed: the kernel's plain
# version against the explicit path (forward), and the backward's plain
# formulas against autograd through the explicit path. fp32, 1e-5.

DROP_TOL = dict(rtol=1e-5, atol=1e-5)
RATE, SEED = 0.3, 0x5EED


@cases
@dims
@masks
def test_flash_plain_dropout_matches_explicit(t, s, dh, masked):
    q, k, v, mask = (_t(x) for x in _inputs(t, s, dh, masked))
    o, lse = tattn.flash_attention_plain(q, k, v, H, mask, RATE, SEED)
    o0, lse0 = tattn.flash_attention_plain(q, k, v, H, mask)
    assert torch.equal(lse, lse0)          # lse ignores the mask
    kb = None if mask is None else ((1.0 - mask) * -1e9)[:, None, None, :]
    want = tattn.explicit_attention(q, k, v, H, kb, RATE, SEED)
    rows = slice(0, 2) if masked else slice(None)   # row 2: zeros vs uniform
    np.testing.assert_allclose(o[rows].numpy(), want[rows].numpy(),
                               **DROP_TOL)
    assert not torch.allclose(o, o0)


@cases
@dims
@masks
def test_bwd_plain_matches_autograd_of_explicit(t, s, dh, masked):
    q, k, v, mask = (_t(x) for x in _inputs(t, s, dh, masked))
    do = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape).astype(np.float32))
    o, lse = tattn.flash_attention_plain(q, k, v, H, mask, RATE, SEED)
    got = tattn.flash_attention_bwd_plain(q, k, v, o, lse, do, H, mask,
                                          RATE, SEED)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    if mask is None:
        out = tattn.explicit_attention(qr, kr, vr, H, None, RATE, SEED)
        out.backward(do)
        want = (qr.grad, kr.grad, vr.grad)
    else:
        # the explicit path's -1e9 bias makes a row with no valid key
        # uniform; mask that row's output gradient so both sides agree
        kb = ((1.0 - mask) * -1e9)[:, None, None, :]
        live = (mask.sum(1) > 0).float()[:, None, None]
        out = tattn.explicit_attention(qr, kr, vr, H, kb, RATE, SEED)
        out.backward(do * live)
        want = (qr.grad, kr.grad, vr.grad)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **DROP_TOL)
    if masked:
        assert all(bool((g[2] == 0).all()) for g in got)


@cases
@dims
@masks
def test_bwd_plain_matches_flash_bwd(t, s, dh, masked):
    """Rate 0: the plain backward against JAX's _flash_bwd, reached through
    jax.vjp of the custom-VJP cores (Pallas in interpret mode)."""
    import jax

    q, k, v, mask = _inputs(t, s, dh, masked)
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    if mask is None:
        _, vjp = jax.vjp(lambda a, b, c: jattn._fused_attention(a, b, c, H),
                         jq, jk, jv)
    else:
        kb = jnp.asarray((1.0 - mask) * -1e9)
        _, vjp = jax.vjp(
            lambda a, b, c: jattn._fused_attention_core_masked(
                a, b, c, kb, jnp.zeros((1,), jnp.int32), H, 0.0), jq, jk, jv)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    o, lse = tattn.flash_attention_plain(tq, tk, tv, H, tm)
    got = tattn.flash_attention_bwd_plain(tq, tk, tv, o, lse, _t(do), H, tm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_attention_autograd_runs_the_plain_backward():
    """fused_attention on CPU tensors: the autograd Function's grads are
    flash_attention_bwd_plain's, with the forward's seed."""
    q, k, v, mask = (_t(x) for x in _inputs(64, 40, 32, True))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(3))
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    before = (tattn.launches, tattn.bwd_launches)
    o = tattn.fused_attention(qr, kr, vr, H, mask, RATE, SEED)
    o.backward(do)
    assert (tattn.launches, tattn.bwd_launches) == before   # no kernel ran
    o_p, lse = tattn.flash_attention_plain(q, k, v, H, mask, RATE, SEED)
    assert torch.equal(o.detach(), o_p)
    want = tattn.flash_attention_bwd_plain(q, k, v, o_p, lse, do, H, mask,
                                           RATE, SEED)
    for g, w in zip((qr.grad, kr.grad, vr.grad), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("t,s", [(64, 64), (16, 40)])
def test_fused_and_explicit_routes_draw_one_mask(t, s):
    """multi_head_attention with dropout: the fused and explicit routes
    drop the same weights for one seed, forward and backward."""
    q, k, v, _ = (_t(x) for x in _inputs(t, s, 32, False))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    outs = []
    for fused in (True, False):
        qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
        o = tattn.multi_head_attention(qr, kr, vr, H, dropout_rate=RATE,
                                       dropout_seed=SEED,
                                       deterministic=False, fused=fused)
        o.backward(do)
        outs.append((o.detach(), qr.grad, kr.grad, vr.grad))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **DROP_TOL)
    det = tattn.multi_head_attention(q, k, v, H, dropout_rate=RATE,
                                     dropout_seed=SEED, deterministic=True,
                                     fused=True)
    assert torch.equal(det, tattn.flash_attention_plain(q, k, v, H)[0])
