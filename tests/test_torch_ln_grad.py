"""The (residual +) LayerNorm's VJP (#6 under its autograd Function) and
the routing rules that send work to the kernels (ROADMAP C1, C2).

#6's backward is the plain port of the JAX package's `_ln_adjoint`: here
`fused_layernorm_bwd_plain` against jax.grad through the JAX package's
`fused_layernorm` (its custom VJP) and the reference composition of
tests/test_encoders.py::test_fused_ln_grads_match_jnp, at its tolerance
(2e-4 relative and absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import layers as JL
from mmd_tpu.ops.ln import fused_layernorm as j_fused_layernorm
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import ln as LN
from mmd_tpu_torch.ops import mlp as M

TOL = 2e-4


@pytest.mark.parametrize("dtype,residual", [(torch.float32, True),
                                            (torch.float32, False),
                                            (torch.bfloat16, True)])
def test_ln_vjp_matches_jax(dtype, residual):
    rng = np.random.default_rng(0)
    p = {"scale": rng.standard_normal(128).astype(np.float32),
         "bias": rng.standard_normal(128).astype(np.float32)}
    y = rng.standard_normal((2, 8, 128)).astype(np.float32)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    g = rng.standard_normal((2, 8, 128)).astype(np.float32)

    def loss_fused(p, y, x):
        out = j_fused_layernorm(p, y, 1e-5, shortcut=x if residual else None)
        return jnp.sum(out * g)

    def loss_ref(p, y, x):
        out = JL.layernorm(p, y, 1e-5)
        return jnp.sum(((x + out) if residual else out) * g)

    args = ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(y),
            jnp.asarray(x))
    jf = jax.grad(loss_fused, argnums=(0, 1, 2))(*args)
    jr = jax.grad(loss_ref, argnums=(0, 1, 2))(*args)

    weight = torch.from_numpy(p["scale"])
    ty = torch.from_numpy(y).to(dtype)
    dy, dscale, dbias = LN.fused_layernorm_bwd_plain(
        weight, ty, 1e-5, torch.from_numpy(g).to(dtype))
    assert dy.dtype == dtype and dscale.dtype == torch.float32
    # bf16: y and g rounded to bf16 first, dy rounded once
    tol = TOL if dtype == torch.float32 else 2e-2
    for want in (jf, jr):
        for got, w in ((dscale, want[0]["scale"]), (dbias, want[0]["bias"]),
                       (dy, want[1])):
            np.testing.assert_allclose(got.float().numpy(), np.asarray(w),
                                       rtol=tol, atol=tol)


def test_plain_forward_autograd_agrees_with_the_vjp():
    """On the CPU fused_layernorm is the plain version, which autograd
    differentiates: the same gradients as the Function's backward."""
    g = torch.Generator().manual_seed(1)
    ln = torch.nn.LayerNorm(256)
    with torch.no_grad():
        ln.weight.normal_(generator=g)
        ln.bias.normal_(generator=g)
    y = torch.randn(16, 256, generator=g, requires_grad=True)
    x = torch.randn(16, 256, generator=g, requires_grad=True)
    d = torch.randn(16, 256, generator=g)
    out = LN.fused_layernorm(ln, y, 1e-5, x)
    got = torch.autograd.grad(out, (y, ln.weight, ln.bias, x), d)
    dy, dscale, dbias = LN.fused_layernorm_bwd_plain(ln.weight.detach(),
                                                     y.detach(), 1e-5, d)
    for a, b in zip(got, (dy, dscale, dbias, d)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c,want", [(128, True), (1024, True), (1152, False),
                                    (2048, False), (100, False)])
def test_fused_ln_ok_admits_only_what_the_kernel_takes(c, want):
    assert LN.fused_ln_ok((8, c)) is want


@pytest.mark.parametrize("d,f,want", [(128, 512, True), (256, 1024, True),
                                      (384, 1536, True), (512, 2048, True),
                                      (1024, 4096, True), (640, 2560, True),
                                      (1152, 4608, False), (2048, 8192, False),
                                      (192, 768, False), (384, 1000, False)])
def test_fused_mlp_routing_takes_only_the_kernels_widths(d, f, want):
    """needs_fused_mlp sends #3/#4 every D and F that are multiples of 128,
    as the JAX rule does, with D up to the kernels' cap (MAX_WIDTH, 1024);
    a wider D takes the unfused composition (ROADMAP §C)."""
    assert L.needs_fused_mlp(torch.bfloat16, 0.1, False,
                             torch.device("cuda"), d, f) is want
    assert M.kernel_widths_ok(d, f) is want
    assert (d % 128 == 0 and f % 128 == 0 and d <= M.MAX_WIDTH) is want
