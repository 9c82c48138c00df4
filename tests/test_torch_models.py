"""Port models (mmd_tpu_torch/models) against the JAX package.

Params are made by the JAX package's own init, carried over by the bridge,
and the same numpy inputs go through both forwards. Widths reach the
attention kernel: head dim 32 (the JAX package routes smaller head dims
away from its Pallas kernel, which here runs in interpret mode).

Tolerances: fp32 outputs within 1e-4 (a few layers of fp32 matmuls summed
in another order); the bf16 fusion case within 3e-2 on the logits, because
both sides round every matmul input and activation to bf16 (8 mantissa
bits, ~4e-3 relative), at slightly different places (PyTorch rounds a
bf16 matmul's output before adding the bias, JAX after).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.core.config import ModelConfig as JModelConfig
from mmd_tpu.models import fusion as jfusion
from mmd_tpu.models import layers as jL
from mmd_tpu.models import text_encoder as jte
from mmd_tpu.models import vit as jvit
from mmd_tpu.models.transformer import TransformerConfig as JTransformerConfig
from mmd_tpu_torch import bridge
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.models import fusion as tfusion
from mmd_tpu_torch.models import layers as tL
from mmd_tpu_torch.models import text_encoder as tte
from mmd_tpu_torch.models import vit as tvit
from mmd_tpu_torch.models.transformer import TransformerConfig

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)

TEXT_CFG = JTransformerConfig(vocab_size=128, hidden_size=64, num_layers=2,
                              num_heads=2, intermediate_size=128,
                              max_position=64, compute_dtype="float32")
VIT_CFG = jvit.ViTConfig(image_size=32, patch_size=8, hidden_size=64,
                         num_layers=2, num_heads=2, intermediate_size=128,
                         compute_dtype="float32")
FUSION_KW = dict(text_input_dim=64, image_input_dim=64, embed_dim=64,
                 num_heads=2, hidden_dim=16, compute_dtype="float32",
                 fused_attn=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(cfg, cls):
    return cls(**dataclasses.asdict(cfg))


# -- layers -------------------------------------------------------------------

def _lin_tree(rng, i, o):
    return {"w": rng.standard_normal((i, o)).astype(np.float32) * 0.2,
            "b": rng.standard_normal(o).astype(np.float32) * 0.1}


def test_linear_matches():
    rng = np.random.default_rng(0)
    tree = _lin_tree(rng, 48, 24)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    lin = tL.linear_init(torch.Generator().manual_seed(0), 48, 24)
    bridge.load_jax_tree(lin, tree)
    with torch.no_grad():
        got = tL.linear(lin, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jL.linear(tree, x)), **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6, 1e-7])
def test_layernorm_matches(eps):
    rng = np.random.default_rng(1)
    tree = {"scale": rng.standard_normal(40).astype(np.float32),
            "bias": rng.standard_normal(40).astype(np.float32)}
    # variance ~1e-6, so every eps here moves the result
    x = (rng.standard_normal((4, 7, 40)) * 1e-3).astype(np.float32)
    ln = tL.layernorm_init(40)
    bridge.load_jax_tree(ln, tree)
    with torch.no_grad():
        got = tL.layernorm(ln, torch.from_numpy(x), eps).numpy()
    np.testing.assert_allclose(got, np.asarray(jL.layernorm(tree, x, eps)),
                               **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches(dtype):
    """erf-GELU under fp32, tanh-GELU under bf16, on both sides."""
    rng = np.random.default_rng(2)
    tree = {"fc1": _lin_tree(rng, 32, 128), "fc2": _lin_tree(rng, 128, 32)}
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    p = tL.mlp_init(torch.Generator().manual_seed(0), 32)
    bridge.load_jax_tree(p, tree)
    with torch.no_grad():
        got = tL.mlp(p, torch.from_numpy(x),
                     dtype=tL.dtype_of(dtype)).float().numpy()
    want = np.asarray(jL.mlp(tree, jnp.asarray(x), dtype=jnp.dtype(dtype)),
                      np.float32)
    tol = TOL if dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, want, **tol)


def test_head_apply_matches():
    rng = np.random.default_rng(3)
    tree = {"fc0": _lin_tree(rng, 32, 16), "fc1": _lin_tree(rng, 16, 8),
            "fc2": _lin_tree(rng, 8, 3)}
    x = rng.standard_normal((5, 32)).astype(np.float32)
    p = tL.head_init(torch.Generator().manual_seed(0), [32, 16, 8, 3])
    bridge.load_jax_tree(p, tree)
    with torch.no_grad():
        got = tL.head_apply(p, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jL.head_apply(tree, x)), **TOL)


# -- encoders -----------------------------------------------------------------

@pytest.fixture(scope="module")
def text_params():
    return _np_tree(jte.init_text_encoder(jax.random.key(0), TEXT_CFG))


@pytest.mark.parametrize("fused", [True, False])
def test_text_encoder_matches(text_params, fused):
    cfg = dataclasses.replace(TEXT_CFG, fused_attn=fused)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
    mask = np.ones((3, 40), np.int32)
    mask[1, 25:] = 0                       # padded rows
    mask[2, 6:] = 0
    want = np.asarray(jte.encode(text_params, cfg, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    pcfg = _port(cfg, TransformerConfig)
    params = bridge.text_encoder_from_jax(text_params, pcfg)
    with torch.no_grad():
        got = tte.encode(params, pcfg, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with torch.no_grad():
        pooled = tte.mean_pool(torch.from_numpy(got),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(
        pooled, np.asarray(jte.mean_pool(jnp.asarray(want), mask)), **TOL)


@pytest.mark.parametrize("fused", [True, False])
def test_vit_matches(fused):
    cfg = dataclasses.replace(VIT_CFG, fused_attn=fused)
    tree = _np_tree(jvit.init_vit(jax.random.key(1), cfg))
    rng = np.random.default_rng(5)
    imgs = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jvit.vit_forward(tree, cfg, jnp.asarray(imgs)))
    pcfg = _port(cfg, tvit.ViTConfig)
    params = bridge.vit_from_jax(tree, pcfg)
    with torch.no_grad():
        got = tvit.vit_forward(params, pcfg, torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, cfg.num_tokens, cfg.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)


def test_additive_mask_attention_matches():
    """The 4D additive-mask slot of _masked_attention (causal/bias masks),
    fed by attention_mask_from_ids, against the JAX package."""
    from mmd_tpu.models import transformer as jtr
    from mmd_tpu_torch.models import transformer as ttr
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 12, 64)).astype(np.float32)
               for _ in range(3))
    ids_mask = np.ones((2, 12), np.int32)
    ids_mask[1, 7:] = 0
    want = np.asarray(jtr._masked_attention(
        *map(jnp.asarray, (q, k, v)), 2,
        jtr.attention_mask_from_ids(jnp.asarray(ids_mask), 12), True))
    mask = ttr.attention_mask_from_ids(torch.from_numpy(ids_mask), 12)
    got = ttr._masked_attention(*map(torch.from_numpy, (q, k, v)), 2, mask,
                                True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_patchify_order_matches():
    x = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    np.testing.assert_array_equal(
        tvit.patchify(torch.from_numpy(x), 4).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(x), 4)))


# -- fusion -------------------------------------------------------------------

def _fusion_inputs(seed=6):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 24, 64), (2, 16, 64), (2, 24, 64), (2, 16, 64))]


def _run_fusion(kw, inputs, drop=()):
    jcfg = JModelConfig(**kw)
    tree = _np_tree(jfusion.init_fusion_params(jax.random.key(2), jcfg))
    args = [None if i in drop else x for i, x in enumerate(inputs)]
    want = jfusion.fusion_forward(
        tree, jcfg, *[None if a is None else jnp.asarray(a) for a in args])
    pcfg = ModelConfig(**kw)
    params = bridge.fusion_from_jax(tree, pcfg)
    with torch.no_grad():
        got = tfusion.fusion_forward(
            params, pcfg,
            *[None if a is None else torch.from_numpy(a) for a in args])
    return got, want


def _flat(out):
    if isinstance(out, tuple):
        return [y for part in out for y in
                (part if isinstance(part, tuple) else (part,))]
    return [out]


def _assert_logits(got, want, tol):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("mode", ["paths", "factify", "text_only"])
@pytest.mark.parametrize("parity_cross_kv", [True, False])
def test_fusion_matches(mode, parity_cross_kv):
    kw = dict(FUSION_KW, parity_cross_kv=parity_cross_kv,
              factify=mode == "factify", text_only=mode == "text_only")
    _assert_logits(*_run_fusion(kw, _fusion_inputs()), TOL)


@pytest.mark.parametrize("parity_cross_kv", [True, False])
def test_fusion_explicit_attention_matches(parity_cross_kv):
    kw = dict(FUSION_KW, fused_attn=False, parity_cross_kv=parity_cross_kv)
    _assert_logits(*_run_fusion(kw, _fusion_inputs()), TOL)


def test_fusion_missing_image_modality():
    """Text-only inputs in 4-path mode: the image paths come back None."""
    got, want = _run_fusion(FUSION_KW, _fusion_inputs(), drop=(1, 3))
    _assert_logits(got, want, TOL)
    assert got[0][1] is None and got[1] == (None, None)


def test_fusion_bf16_matches():
    """bf16 compute (tanh-GELU in the MLPs) within 3e-2 on the logits."""
    kw = dict(FUSION_KW, compute_dtype="bfloat16")
    _assert_logits(*_run_fusion(kw, _fusion_inputs()),
                   dict(rtol=3e-2, atol=3e-2))


def test_fusion_training_forward_raises():
    """The training forward needs a generator for its dropout seeds, as the
    JAX forward needs an rng."""
    cfg = ModelConfig(**FUSION_KW)
    params = tfusion.init_fusion_params(torch.Generator().manual_seed(0), cfg)
    x = [torch.from_numpy(a) for a in _fusion_inputs()]
    with pytest.raises(ValueError, match="seed"):
        tfusion.fusion_forward(params, cfg, *x, deterministic=False)


def test_tensor_parallel_config_raises():
    with pytest.raises(NotImplementedError):
        ModelConfig(tensor_parallel=True)


def test_seeded_init_is_deterministic():
    cfg = ModelConfig(**FUSION_KW)
    a = tfusion.init_fusion_params(torch.Generator().manual_seed(3), cfg)
    b = tfusion.init_fusion_params(torch.Generator().manual_seed(3), cfg)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_bridge_rejects_missing_and_extra_keys():
    cfg = ModelConfig(**FUSION_KW)
    tree = _np_tree(jfusion.init_fusion_params(jax.random.key(0),
                                               JModelConfig(**FUSION_KW)))
    missing = dict(tree, representation=dict(tree["representation"]))
    del missing["representation"]["text_proj"]
    with pytest.raises(KeyError, match="text_proj"):
        bridge.fusion_from_jax(missing, cfg)
    extra = dict(tree, classifier=dict(tree["classifier"], stray={}))
    with pytest.raises(KeyError, match="stray"):
        bridge.fusion_from_jax(extra, cfg)
    wrong = dict(tree, cross_attn=dict(tree["cross_attn"]))
    wrong["cross_attn"]["text_WQ"] = {"w": np.zeros((3, 3), np.float32),
                                      "b": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        bridge.fusion_from_jax(wrong, cfg)
