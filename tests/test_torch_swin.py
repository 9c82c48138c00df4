"""The port's Swinv2 encoder (mmd_tpu_torch/models/swin.py) and its window
attention op (mmd_tpu_torch/ops/swin_attention.py) against the JAX package.

The op's plain version, which the CUDA kernel is held to on the card, is
compared with the JAX package's serving kernel `swin_window_attention_infer`
in interpret mode. The JAX kernel takes its bias and scale in the log2
domain, packed for Mosaic; the port takes them in natural log. Everything
is fp32 here: the TPU kernel's bf16 path rounds the squares before its
norms, the port's does not.

Tolerances: 2e-5 on the op (fp32 on both sides), 1e-4 on the model (a few
blocks of fp32 matmuls summed in another order).
"""

import dataclasses
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

MTOL = dict(rtol=1e-4, atol=1e-4)
LOG2E = 1.4426950408889634
# stage 0: 16 x 16 tokens in four 8 x 8 windows, its second block shifted;
# stage 1 (after a patch merge): one 8 x 8 window, no shift; dh 32 in both
KERNEL_CFG = JS.SwinConfig(image_size=64, patch_size=4, embed_dim=128,
                           depths=(2, 2), num_heads=(4, 8), window_size=8,
                           pretrained_window_sizes=(0, 0),
                           compute_dtype="float32")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_plain_matches_pallas_kernel(shifted):
    nw, b, n, c, heads = 4, 2, 64, 128, 4
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((nw, b, n, c)).astype(np.float32)
               for _ in range(3))
    cpb = (16.0 / (1.0 + np.exp(-rng.standard_normal((heads, n, n))))
           ).astype(np.float32)
    logit = np.log(np.array([2.0, 10.0, 50.0, 300.0], np.float32))
    scale = np.exp(np.minimum(logit, math.log(100.0))).astype(np.float32)
    if shifted:
        mask = JS.shift_attn_mask(16, 8, 4)
        assert mask.shape == (nw, n, n) and mask.min() < 0
        bias = cpb[None] + 2.0 * mask[:, None]
    else:
        bias = np.broadcast_to(cpb[None], (nw, heads, n, n))
    scale_row = np.broadcast_to(np.repeat(scale * LOG2E, c // heads)[None],
                                (8, c)).astype(np.float32)
    want = np.asarray(JSA.swin_window_attention_infer(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(bias * LOG2E), jnp.asarray(scale_row), heads))
    tbias = torch.from_numpy(np.ascontiguousarray(bias if shifted
                                                  else cpb[None]))
    got = TSA.swin_window_attention_infer(
        *map(torch.from_numpy, (q, k, v)), tbias, torch.from_numpy(scale),
        heads).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_swin_forward_matches_jax(fused):
    """fused_attn and fused_ln both on (the kernel path) or both off."""
    jcfg = dataclasses.replace(KERNEL_CFG, fused_attn=fused, fused_ln=fused)
    assert jcfg.stage_window_shift(0, 1)[1] > 0
    tree = _np_tree(JS.init_swin(jax.random.key(3), jcfg))
    tcfg = TS.SwinConfig(**dataclasses.asdict(jcfg))
    params = bridge.swin_from_jax(tree, tcfg)
    imgs = np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JS.swin_forward(tree, jcfg, imgs))
    with torch.no_grad():
        got = TS.swin_forward(params, tcfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, tcfg.num_tokens, tcfg.hidden_size) == (2, 64, 256)
    np.testing.assert_allclose(got, want, **MTOL)


def test_swin_test_config_matches_jax():
    """SWIN_TEST (dh 8, C 16): no block or LayerNorm passes the kernels'
    gates, so both packages take the explicit path throughout."""
    jcfg = JS.SWIN_TEST
    tree = _np_tree(JS.init_swin(jax.random.key(1), jcfg))
    tcfg = TS.SwinConfig(**dataclasses.asdict(jcfg))
    params = bridge.swin_from_jax(tree, tcfg)
    imgs = np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(JS.swin_forward(tree, jcfg, imgs))
    with torch.no_grad():
        got = TS.swin_forward(params, tcfg, torch.from_numpy(imgs)).numpy()
    np.testing.assert_allclose(got, want, **MTOL)


def test_kernel_path_routes_every_block(monkeypatch):
    """KERNEL_CFG's four blocks all take the window-attention op, and its
    LayerNorms the fused op: 1 embed + 2 per block + 1 merge + 1 final.
    Every tensor they get is contiguous, as the CUDA kernels require."""
    from mmd_tpu_torch.ops import ln as tln

    calls = {"attn": 0, "ln": 0}
    attn, lnf = TS.swin_window_attention_infer, TS.fused_layernorm

    def count_attn(*a, **k):
        calls["attn"] += 1
        assert all(t.is_contiguous() for t in a[:5])
        return attn(*a, **k)

    def count_ln(*a, **k):
        calls["ln"] += 1
        assert tln.fused_ln_ok(a[1].shape) and a[1].is_contiguous()
        assert k.get("shortcut") is None or k["shortcut"].is_contiguous()
        return lnf(*a, **k)

    monkeypatch.setattr(TS, "swin_window_attention_infer", count_attn)
    monkeypatch.setattr(TS, "fused_layernorm", count_ln)
    tcfg = TS.SwinConfig(**dataclasses.asdict(KERNEL_CFG))
    params = TS.init_swin(torch.Generator().manual_seed(0), tcfg)
    with torch.no_grad():
        TS.swin_forward(params, tcfg, torch.zeros(1, 64, 64, 3))
    assert calls == {"attn": 4, "ln": 1 + 2 * 4 + 1 + 1}


@pytest.mark.parametrize("window,dh,heads", [
    (8, 32, 4), (8, 32, 8), (8, 32, 16), (8, 32, 32), (8, 32, 3), (8, 64, 2),
    (8, 16, 8), (4, 32, 4), (16, 32, 4), (8, 48, 2), (7, 32, 4)])
def test_fused_ok_matches_jax(window, dh, heads):
    """The JAX rule, narrowed to the kernels' windows of 64 tokens and head
    dims 32 and 64 (16 x 16 windows take the explicit path)."""
    assert TSA.fused_ok(window, dh, heads) == (
        JS._fused_ok(window, dh, heads) and window * window == 64
        and dh in (32, 64))


@pytest.mark.parametrize("name", ["relative_coords_table",
                                  "relative_position_index",
                                  "shift_attn_mask"])
def test_static_tables_match_jax(name):
    for w in (4, 8):
        if name == "relative_coords_table":
            for pw in (0, 12):
                np.testing.assert_array_equal(
                    TS.relative_coords_table(w, pw),
                    JS.relative_coords_table(w, pw))
        elif name == "relative_position_index":
            np.testing.assert_array_equal(TS.relative_position_index(w),
                                          JS.relative_position_index(w))
        else:
            for res, shift in ((16, w // 2), (16, 0), (8, w // 2)):
                a, b = (TS.shift_attn_mask(res, w, shift),
                        JS.shift_attn_mask(res, w, shift))
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)


def test_fine_tuning_options_raise():
    """remat and fused_train run now (the forward under remat is the one
    without it, and the gradient reaches the params); what still raises is
    the fine-tuning op on a device that is neither cpu nor cuda."""
    params = TS.init_swin(torch.Generator().manual_seed(0), TS.SWIN_TEST)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = TS.swin_forward(params, TS.SWIN_TEST, x)
    for kw in ({"remat": True}, {"fused_train": True},
               {"remat": True, "fused_train": True}):
        cfg = dataclasses.replace(TS.SWIN_TEST, **kw)
        params.zero_grad()
        got = TS.swin_forward(params, cfg, x)
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
        got.square().sum().backward()
        assert params["patch_embed"].weight.grad is not None
    q = torch.zeros(1, 1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        TSA.swin_window_attention(q, q, q, torch.zeros(1, 2, 64, 64,
                                                       device="meta"), 2)
