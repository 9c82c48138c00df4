"""The DeBERTa disentangled-attention backward (#11) against the JAX
package: the port's plain backward `deberta_attention_bwd_plain`, and
autograd through the port's `deberta_attention` (the plain versions under
its autograd Function on the CPU), against jax.grad of
`_deberta_attn_trainable` (the Pallas forward and backward kernels in
interpret mode, as tests/test_deberta_bwd.py runs them), at the JAX test's
geometries, fp32, with a padded tail row and a row with no valid key.

Tolerance: 1e-5 of each gradient's largest |value| (fp32 sums in another
order); the reference is the fp32 math, which the Pallas backward
computes whatever LOWP_SCORES says (it rounds only bf16 forwards).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.models import deberta as JD
from mmd_tpu_torch.ops import deberta_attention as DA

REL = 1e-5
NAMES = ("dq", "dk", "dv", "dPK", "dPQ")


def _inputs(t, dim, seed):
    rng = np.random.default_rng(seed)
    b = 3
    arrs = [rng.standard_normal((b, t, dim)).astype(np.float32)
            for _ in range(3)]
    arrs += [rng.standard_normal((2 * t, dim)).astype(np.float32)
             for _ in range(2)]
    mask = np.ones((b, t), np.int32)
    mask[1, t - 11:] = 0                    # padded tail
    mask[2, :] = 0                          # no valid key: uniform P
    do = rng.standard_normal((b, t, dim)).astype(np.float32)
    return arrs, mask, do


def _jax_grads(arrs, mask, do, heads, scale):
    def f(q, k, v, pk, pq):
        return JD._deberta_attn_trainable(q, k, v, pk, pq, jnp.asarray(mask),
                                          heads, scale)
    out, vjp = jax.vjp(f, *map(jnp.asarray, arrs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close(got, want, name):
    scale = float(np.abs(want).max())
    gap = float(np.abs(got - want).max())
    assert gap <= REL * scale, (name, gap, scale)


@pytest.mark.parametrize("t,heads,dim", [(64, 2, 64), (128, 4, 128)])
def test_plain_backward_and_autograd_match_jax(t, heads, dim):
    arrs, mask, do = _inputs(t, dim, t + heads)
    scale = 1.0 / math.sqrt((dim // heads) * 3.0)
    jout, jgrads = _jax_grads(arrs, mask, do, heads, scale)

    tm = torch.from_numpy(mask)
    plain = DA.deberta_attention_bwd_plain(
        *map(torch.from_numpy, arrs), tm, torch.from_numpy(do), heads, scale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    out = DA.deberta_attention(*leaves, tm, heads, scale)
    _close(out.detach().numpy(), jout, "o")
    auto = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, p, a, w in zip(NAMES, plain, auto, jgrads):
        assert p.dtype == torch.float32 and p.shape == w.shape, name
        _close(p.numpy(), w, name)
        _close(a.numpy(), w, name)
    # the padded keys and the row with no valid key take no score gradient:
    # that row's dq is 0, as the reference's `where` makes it
    assert float(plain[0][2].abs().max()) == 0.0
