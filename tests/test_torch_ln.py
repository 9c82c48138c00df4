"""The port's (residual +) LayerNorm (mmd_tpu_torch/ops/ln.py) against the
JAX package's fused_layernorm, whose Pallas kernel runs here in interpret
mode.

On the CPU the port's wrapper runs its plain version, the function the CUDA
kernel is held to on the card. Tolerances: fp32 2e-5 (fp32 statistics on
both sides, summed in another order); bf16 2e-2, one bf16 rounding of the
output (|out| up to ~6 here, where a bf16 step is 3e-2, and both sides
round the same fp32 value, so they differ only where it lies within
rounding error of a step's midpoint).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import layers as jL
from mmd_tpu.ops import ln as jln
from mmd_tpu_torch import bridge
from mmd_tpu_torch.models import layers as tL
from mmd_tpu_torch.ops import ln as tln

torch.set_num_threads(2)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _params(rng, c):
    tree = {"scale": rng.standard_normal(c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32)}
    mod = tL.layernorm_init(c)
    bridge.load_jax_tree(mod, tree)
    return tree, mod


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_layernorm_matches_jax(dtype, residual):
    rng = np.random.default_rng(0)
    tree, mod = _params(rng, 256)
    y = (rng.standard_normal((4, 16, 256)) * 3 + 1).astype(np.float32)
    x = rng.standard_normal((4, 16, 256)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    assert jln.fused_ln_ok(y.shape) and tln.fused_ln_ok(y.shape)
    want = jln.fused_layernorm(
        {k: jnp.asarray(v) for k, v in tree.items()},
        jnp.asarray(y, jdt), 1e-5,
        shortcut=jnp.asarray(x, jdt) if residual else None)
    with torch.no_grad():
        got = tln.fused_layernorm(
            mod, torch.from_numpy(y).to(tdt), 1e-5,
            shortcut=torch.from_numpy(x).to(tdt) if residual else None)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("residual", [False, True])
def test_refused_geometry_takes_layernorm(residual):
    """(3, 100): C is no multiple of 128, so both packages take the plain
    LayerNorm and add the shortcut after its cast."""
    rng = np.random.default_rng(1)
    tree, mod = _params(rng, 100)
    y = rng.standard_normal((3, 100)).astype(np.float32)
    x = rng.standard_normal((3, 100)).astype(np.float32)
    assert not tln.fused_ln_ok(y.shape) and not jln.fused_ln_ok(y.shape)
    sc = torch.from_numpy(x) if residual else None
    with torch.no_grad():
        got = tln.fused_layernorm(mod, torch.from_numpy(y), 1e-5, shortcut=sc)
        plain = tL.layernorm(mod, torch.from_numpy(y), 1e-5)
    torch.testing.assert_close(got, plain if sc is None else sc + plain,
                               rtol=0, atol=0)
    want = jln.fused_layernorm(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(y), 1e-5,
        shortcut=jnp.asarray(x) if residual else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])


@pytest.mark.parametrize("shape", [(8, 128), (3, 16, 256), (65536, 128),
                                   (1024, 1024), (4, 100), (7, 128), (256,),
                                   (2, 3, 384)])
def test_fused_ln_ok_matches_jax(shape):
    assert tln.fused_ln_ok(shape) == jln.fused_ln_ok(shape)


def test_plain_version_matches_layernorm():
    """The plain version is the LayerNorm of layers.py plus the shortcut
    in fp32, cast once."""
    rng = np.random.default_rng(2)
    _, mod = _params(rng, 128)
    y = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(
            tln.fused_layernorm_plain(mod, y, 1e-6, x),
            x + tL.layernorm(mod, y, 1e-6), rtol=1e-6, atol=1e-6)


def test_unknown_device_type_raises():
    _, mod = _params(np.random.default_rng(3), 128)
    y = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tln.fused_layernorm(mod, y)
