"""The port's ResNet feature extractor (mmd_tpu_torch/models/resnet.py)
against the JAX package's (mmd_tpu/models/resnet.py), on the CPU.

The same weights go to both through bridge.resnet_from_jax (HWIO kernels
become OIHW). Tolerances: fp32 features within 1e-5 of the largest
|feature|; bf16 within 2e-2 of it (both round every conv output and
every folded BN to bf16, in another summation order). Sizes 64 and 33:
even and odd inputs exercise XLA's "SAME" padding, which the port makes
explicit (the odd pixel at the high end), not PyTorch's symmetric
padding -- so torchvision's own features are not reproduced, in either
package (pinned below). The torchvision loader is held bit for bit
against the JAX loader on a state dict with torchvision's names and
shapes (torchvision itself is not needed).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmd_tpu.models import resnet as JR
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import resnet as TR

torch.set_num_threads(2)

CONFIGS = {"test": (JR.RESNET_TEST, TR.RESNET_TEST),
           "four_stages": (JR.ResNetConfig(stage_sizes=(1, 1, 1, 1), width=8),
                           TR.ResNetConfig(stage_sizes=(1, 1, 1, 1), width=8))}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(name, dtype, seed=0):
    jcfg, tcfg = CONFIGS[name]
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  JR.init_resnet(jax.random.key(seed), jcfg))
    # non-trivial folded BN, so scale and shift are exercised
    rng = np.random.default_rng(seed)
    for p in [tree] + tree["blocks"]:
        for k, v in p.items():
            if k.startswith("bn"):
                v["scale"] = (1 + 0.1 * rng.standard_normal(
                    v["scale"].shape)).astype(np.float32)
                v["shift"] = (0.1 * rng.standard_normal(
                    v["shift"].shape)).astype(np.float32)
    return jcfg, tcfg, tree, bridge.resnet_from_jax(tree, tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [64, 33])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_resnet_features_match_jax(name, size, dtype):
    jcfg, tcfg, tree, params = _pair(name, dtype)
    x = np.random.default_rng(1).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    want = np.asarray(JR.resnet_features(tree, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = TR.resnet_features(params, torch.from_numpy(x), tcfg).numpy()
    assert got.shape == want.shape == (2, tcfg.feature_dim)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def test_same_padding_is_xla_rule_not_symmetric():
    """(low, high) as XLA pads; PyTorch's padding=k//2 is another
    function: the stem on 224 and a 3x3 stride-2 conv on 112 differ."""
    assert TR.same_padding(224, 7, 2) == (2, 3)
    assert TR.same_padding(112, 3, 2) == (0, 1)
    assert TR.same_padding(56, 3, 1) == (1, 1)
    assert TR.same_padding(33, 3, 2) == (1, 1)
    assert TR.same_padding(56, 1, 2) == (0, 0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 3, 224, 224, generator=g)
    w = torch.randn(8, 3, 7, 7, generator=g)
    jw = jnp.asarray(w.numpy().transpose(2, 3, 1, 0))
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), jw, (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))).transpose(0, 3, 1, 2)
    same = TR._conv(x, w, 2, torch.float32).numpy()
    symmetric = F.conv2d(x, w, stride=2, padding=3).numpy()
    np.testing.assert_allclose(same, want, rtol=0, atol=1e-4)
    assert np.abs(symmetric - want).max() > 1.0


def _torchvision_state_dict(cfg, seed=2):
    """A resnet state dict with torchvision's names and shapes, random
    values (positive running variances), its fc head and counters."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = rng.standard_normal(
            (cout, cin, k, k)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_mean"] = rng.standard_normal(c).astype(np.float32)
        sd[f"{name}.running_var"] = rng.random(c).astype(np.float32) + 0.1
        sd[f"{name}.num_batches_tracked"] = np.array(7, np.int64)

    conv("conv1", cfg.width, 3, 7)
    bn("bn1", cfg.width)
    cin = cfg.width
    for stage, n in enumerate(cfg.stage_sizes):
        cmid = cfg.width * 2 ** stage
        for b in range(n):
            pre = f"layer{stage + 1}.{b}"
            conv(f"{pre}.conv1", cmid, cin, 1)
            bn(f"{pre}.bn1", cmid)
            conv(f"{pre}.conv2", cmid, cmid, 3)
            bn(f"{pre}.bn2", cmid)
            conv(f"{pre}.conv3", cmid * 4, cmid, 1)
            bn(f"{pre}.bn3", cmid * 4)
            if b == 0:
                conv(f"{pre}.downsample.0", cmid * 4, cin, 1)
                bn(f"{pre}.downsample.1", cmid * 4)
            cin = cmid * 4
    sd["fc.weight"] = rng.standard_normal((10, cin)).astype(np.float32)
    sd["fc.bias"] = np.zeros(10, np.float32)
    return sd


def _assert_identical(got, want, where="resnet"):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_identical(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_identical(g, w, f"{where}[{i}]")
    else:
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=where)


@pytest.mark.parametrize("values", ["numpy", "torch"])
def test_torchvision_loader_bit_identical_to_jax(values):
    cfg = TR.ResNetConfig(stage_sizes=(2, 1), width=8)
    sd = _torchvision_state_dict(cfg)
    want = JR.load_torchvision_state_dict(
        sd, JR.ResNetConfig(stage_sizes=(2, 1), width=8))
    if values == "torch":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    got = bridge.resnet_to_jax(TR.load_torchvision_state_dict(sd, cfg))
    _assert_identical(got, want)
    assert "proj" not in got["blocks"][1] and "proj" in got["blocks"][2]


def test_bridge_round_trip_and_refusals():
    _, tcfg, tree, params = _pair("test", "float32")
    _assert_identical(bridge.resnet_to_jax(params), tree)
    bad = dict(tree, blocks=[dict(tree["blocks"][0]), tree["blocks"][1]])
    del bad["blocks"][0]["proj"]
    with pytest.raises(KeyError, match="proj"):
        bridge.resnet_from_jax(bad, tcfg)
    bad = dict(tree, stem=np.zeros((7, 7, 3, 9), np.float32))
    with pytest.raises(ValueError, match="stem"):
        bridge.resnet_from_jax(bad, tcfg)


def test_block_strides_and_feature_dim_match_jax():
    for jcfg, tcfg in [(JR.ResNetConfig(), TR.ResNetConfig()),
                       *CONFIGS.values()]:
        assert TR.block_strides(tcfg) == JR.block_strides(jcfg)
        assert tcfg.feature_dim == jcfg.feature_dim
    assert TR.ResNetConfig().feature_dim == 2048
