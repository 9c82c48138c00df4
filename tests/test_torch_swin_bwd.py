"""The Swin window attention for fine-tuning (#8 forward, #9 backward)
against the JAX package: the port's plain versions, and autograd through
its `swin_window_attention`, against jax.vjp of the JAX package's
`swin_window_attention` (its Pallas kernels in interpret mode, as
tests/test_swin_bwd.py runs them), dbias included; then a one-stage,
window-8 Swinv2 with and without fused_train against JAX swin_forward's
grads, as test_swin_fused_bwd_matches_einsum holds them.

Tolerances: the op, fp32, within 1e-5 of each output's largest |value|
(sums in another order; the Pallas kernel packs g = 128 / dh heads into
one product); the model, as the JAX test: 1e-3 relative plus 2e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import swin as JS
from mmd_tpu.ops import swin_attention as JSA
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import swin as TS
from mmd_tpu_torch.ops import swin_attention as TSA

REL = 1e-5
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("nw,b,c,heads", [(4, 2, 128, 4), (1, 3, 64, 2),
                                          (2, 2, 256, 8)])
def test_op_and_its_backward_match_jax(nw, b, c, heads):
    rng = np.random.default_rng(nw * 10 + heads)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, b, 64, heads, dh)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(
            nw, b, 64, c).astype(np.float32)

    q = unit(rng.standard_normal((nw, b, 64, c))) * np.float32(12 * LOG2E)
    k = unit(rng.standard_normal((nw, b, 64, c)))
    v = rng.standard_normal((nw, b, 64, c)).astype(np.float32)
    # position bias in (0, 16) plus a -100 region mask twice, log2 domain
    bias = (16 * rng.random((nw, heads, 64, 64))
            - 200 * (rng.random((nw, 1, 64, 64)) < 0.2)) * LOG2E
    bias = bias.astype(np.float32)
    do = rng.standard_normal((nw, b, 64, c)).astype(np.float32)

    jout, vjp = jax.vjp(functools.partial(JSA.swin_window_attention,
                                          heads=heads),
                        *map(jnp.asarray, (q, k, v, bias)))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(do))]

    tq, tk, tv, tb, tdo = map(torch.from_numpy, (q, k, v, bias, do))
    plain_o = TSA.swin_window_attention_plain(tq, tk, tv, tb, heads)
    plain = TSA.swin_window_attention_bwd_plain(tq, tk, tv, tb, tdo, heads)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, tb)]
    out = TSA.swin_window_attention(*leaves, heads)
    auto = torch.autograd.grad(out, leaves, tdo)
    for name, got, want in [("o", plain_o, jout), ("o autograd", out,
                                                   jout)]:
        want = np.asarray(want)
        assert float(np.abs(got.detach().numpy() - want).max()) <= \
            REL * float(np.abs(want).max()), name
    for name, p, a, w in zip(("dq", "dk", "dv", "dbias"), plain, auto,
                             jgrads):
        assert p.shape == w.shape, name
        for got in (p, a):
            gap = float(np.abs(got.numpy() - w).max())
            assert gap <= REL * float(np.abs(w).max()), (name, gap)


@pytest.mark.parametrize("fused_train", [True, False])
def test_swin_forward_grads_match_jax(fused_train):
    """One stage, window 8, head dim 32: fused_train takes the fused,
    differentiable path in both packages (the Pallas kernels in JAX, the
    plain versions under the autograd Function here); without it, the
    explicit path. CPB grads included."""
    jcfg = JS.SwinConfig(image_size=64, patch_size=4, embed_dim=128,
                         depths=(2,), num_heads=(4,), window_size=8,
                         pretrained_window_sizes=(0,), compute_dtype="float32",
                         fused_attn=fused_train, fused_train=fused_train,
                         fused_ln=False)
    tcfg = TS.SwinConfig(**dataclasses.asdict(jcfg))
    assert jcfg.stage_window_shift(0, 1)[1] > 0        # a shifted block too
    jparams = JS.init_swin(jax.random.key(3), jcfg)
    imgs = np.random.default_rng(4).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)

    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(JS.swin_forward(p, jcfg, jnp.asarray(imgs)) ** 2)
    )(jparams)
    tparams = bridge.swin_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams), tcfg)
    loss = TS.swin_forward(tparams, tcfg, torch.from_numpy(imgs)).square(
        ).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = bridge.to_jax_tree(tparams, grads=True)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(jg)[0]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=jax.tree_util.keystr(path))
