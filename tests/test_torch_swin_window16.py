"""Swinv2 window attention at 16 x 16 and 24 x 24 windows (256 and 576
tokens), and a window-16 Swinv2, against the JAX package.

  * the op: the plain serving function (#7's) against the JAX package's
    `swin_window_attention_infer`, and the plain fine-tuning forward (#8's)
    and backward (#9's: dq, dk, dv, dbias) against jax.vjp of its custom VJP
    `swin_window_attention`, the Pallas kernels in interpret mode as the
    JAX package's own tests run them off the TPU; at n 256 and 576, head
    dims 32 and 64, with one bias for every window and a bias per window;
  * the model: the port's `swin_forward` against the JAX package's with
    fused attention (every block on its Pallas kernel): image 128, patch 4,
    embed 64, depths (2, 2), heads (2, 4), window 16 -- stage 0 at res 32
    in four windows, its second block shifted, stage 1 at res 16 in one --
    without and with pretrained windows of 12 (the 12-to-16 fine-tunes);
  * fine-tuning: the gradients of a fused_train loss through the same
    model, against jax.value_and_grad of the JAX package's.

The routing rule sends both stages' blocks to the kernels in both packages
(ops.swin_attention.fused_ok, JAX's _fused_ok), so on the card these are
the kernels' geometries. The JAX side takes the bias and the logit scale
in the log2 domain, as tests/test_torch_swin.py converts them.

Tolerances, as tests/test_torch_swin.py and tests/test_torch_swin_bwd.py
hold the window-8 case: the serving op 2e-5 (fp32 on both sides) of the
function's value in float64, and twice that of the Pallas kernel -- at
logit scale 100 an fp32 rounding of a score moves P by ~1e-5 of itself,
and over 256 or 576 keys the plain version lands up to 1.5e-5 from the
float64 value and the Pallas kernel up to 2.1e-5, so the two differ by up
to 2.3e-5, as tests/test_torch_swin_infer_mirror.py found for its mirror;
the fine-tuning op 1e-5 of each output's largest |value|; the model 1e-4;
its gradients 1e-3 relative plus 2e-4.
"""

import dataclasses
import functools
import math

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

torch.set_num_threads(2)

LOG2E = 1.4426950408889634
REL = 1e-5
MTOL = dict(rtol=1e-4, atol=1e-4)
# (nW, B, n, C, heads): 16 x 16 windows at head dims 32 and 64, a 24 x 24
# window (where the JAX rule needs an even group: head dims 32 and 64 over
# 4 and 2 heads)
OP_GEOMS = [(2, 2, 256, 128, 4), (2, 1, 256, 128, 2), (1, 1, 576, 128, 4),
            (1, 1, 576, 128, 2)]


def _bias(rng, nw, heads, n, per_window):
    """The position bias in (0, 16) plus, per window, twice a 0 / -100
    region mask; or one tile for every window."""
    cpb = 16 * rng.random((heads, n, n))
    if per_window:
        return (cpb[None] - 200.0 * (rng.random((nw, 1, n, n)) < 0.3)
                ).astype(np.float32)
    return cpb[None].astype(np.float32)


def _float64(q, k, v, bias, scale, heads):
    """The serving function in float64."""
    nw, b, n, c = q.shape
    qh, kh, vh = (TSA._split(torch.from_numpy(x).double(), heads)
                  for x in (q, k, v))
    qh = qh / qh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kh = kh / kh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    s = (qh @ kh.transpose(-1, -2)) * torch.from_numpy(scale).double()[
        :, None, None] + torch.from_numpy(bias).double()[:, None]
    o = torch.softmax(s, dim=-1) @ vh
    return o.transpose(2, 3).reshape(nw, b, n, c).numpy()


@pytest.mark.parametrize("per_window", [False, True])
@pytest.mark.parametrize("nw,b,n,c,heads", OP_GEOMS)
def test_serving_op_matches_pallas_kernel(nw, b, n, c, heads, per_window):
    assert TSA.fused_ok(int(math.isqrt(n)), c // heads, heads)
    rng = np.random.default_rng(n + c + heads)
    q, k, v = (rng.standard_normal((nw, b, n, c)).astype(np.float32)
               for _ in range(3))
    bias = _bias(rng, nw, heads, n, per_window)
    logit = np.log(np.array([2.0, 10.0, 50.0, 300.0][:heads], np.float32))
    scale = np.exp(np.minimum(logit, math.log(100.0))).astype(np.float32)
    full = np.broadcast_to(bias, (nw, heads, n, n))
    scale_row = np.broadcast_to(np.repeat(scale * LOG2E, c // heads)[None],
                                (8, c)).astype(np.float32)
    want = np.asarray(JSA.swin_window_attention_infer(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(full * LOG2E), jnp.asarray(scale_row), heads))
    got = TSA.swin_window_attention_infer(
        *map(torch.from_numpy, (q, k, v, bias, scale)), heads).numpy()
    exact = _float64(q, k, v, bias, scale, heads)
    np.testing.assert_allclose(got, exact, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2e-5)


@pytest.mark.parametrize("per_window", [False, True])
@pytest.mark.parametrize("nw,b,n,c,heads", OP_GEOMS)
def test_fine_tuning_op_and_its_backward_match_jax(nw, b, n, c, heads,
                                                  per_window):
    rng = np.random.default_rng(7 * n + heads)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, b, n, heads, dh)
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).reshape(
            nw, b, n, c).astype(np.float32)

    q = unit(rng.standard_normal((nw, b, n, c))) * np.float32(12 * LOG2E)
    k = unit(rng.standard_normal((nw, b, n, c)))
    v, do = (rng.standard_normal((nw, b, n, c)).astype(np.float32)
             for _ in range(2))
    bias = np.ascontiguousarray(np.broadcast_to(
        _bias(rng, nw, heads, n, per_window), (nw, heads, n, n)) * LOG2E
    ).astype(np.float32)
    jout, vjp = jax.vjp(functools.partial(JSA.swin_window_attention,
                                          heads=heads),
                        *map(jnp.asarray, (q, k, v, bias)))
    jgrads = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tb, tdo = map(torch.from_numpy, (q, k, v, bias, do))
    got = TSA.swin_window_attention_plain(tq, tk, tv, tb, heads).numpy()
    want = np.asarray(jout)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
    grads = TSA.swin_window_attention_bwd_plain(tq, tk, tv, tb, tdo, heads)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, jgrads):
        assert tuple(a.shape) == w.shape, name
        gap = float(np.abs(a.numpy() - w).max())
        assert gap <= REL * float(np.abs(w).max()), (name, gap)


def _config(pretrained, **kw):
    return JS.SwinConfig(image_size=128, patch_size=4, embed_dim=64,
                         depths=(2, 2), num_heads=(2, 4), window_size=16,
                         pretrained_window_sizes=pretrained,
                         compute_dtype="float32", **kw)


def test_the_config_takes_the_kernels_at_n_256():
    """Stage 0: res 32 in four 16 x 16 windows, its second block shifted;
    stage 1: res 16, one window, no shift; dh 32 in both, which both rules
    send to the kernels."""
    cfg = _config((0, 0))
    assert [cfg.stage_res(s) for s in range(2)] == [32, 16]
    assert cfg.stage_window_shift(0, 1) == (16, 8)
    assert cfg.stage_window_shift(1, 1) == (16, 0)
    for s in range(2):
        dh = cfg.stage_dim(s) // cfg.num_heads[s]
        assert JS._fused_ok(16, dh, cfg.num_heads[s])
        assert TSA.fused_ok(16, dh, cfg.num_heads[s])


@pytest.mark.parametrize("pretrained", [(0, 0), (12, 12)])
def test_swin_forward_matches_jax(pretrained):
    jcfg = _config(pretrained, fused_attn=True, fused_ln=False)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JS.init_swin(jax.random.key(5), jcfg))
    tcfg = TS.SwinConfig(**dataclasses.asdict(jcfg))
    params = bridge.swin_from_jax(tree, tcfg)
    imgs = np.random.default_rng(6).standard_normal(
        (2, 128, 128, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: JS.swin_forward(p, jcfg, x))(
        tree, imgs))
    with torch.no_grad():
        got = TS.swin_forward(params, tcfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, tcfg.num_tokens, tcfg.hidden_size) == (2, 256,
                                                                   128)
    np.testing.assert_allclose(got, want, **MTOL)


def test_fine_tuning_grads_match_jax():
    """fused_train: the differentiable path in both packages (the Pallas
    kernels in JAX, the plain versions under the autograd Function here),
    position-bias MLP grads included; pretrained windows of 12."""
    jcfg = _config((12, 12), fused_attn=True, fused_train=True,
                   fused_ln=False)
    tcfg = TS.SwinConfig(**dataclasses.asdict(jcfg))
    jparams = JS.init_swin(jax.random.key(7), jcfg)
    imgs = np.random.default_rng(8).standard_normal(
        (2, 128, 128, 3)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jnp.sum(JS.swin_forward(p, jcfg, jnp.asarray(imgs)) ** 2)
    ))(jparams)
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
