"""The port's fused GELU-MLP (mmd_tpu_torch/ops/mlp.py) on the CPU.

The CUDA kernels need a card (tests/test_torch_cuda.py); here their plain
versions, which the wrappers take for CPU tensors, are held against the
JAX package's fused MLP kernel, `_fused_mlp_core`, run in interpret mode as
tests/test_mlp_kernel.py runs it: at rate 0, since the TPU PRNG behind its
masks has no interpret mode. The same inputs, made with numpy, go to both.
Tolerances: fp32 within 2e-5 (forward) and 2e-4 (grads), absolute plus
relative, as tests/test_mlp_kernel.py holds the JAX kernel to its plain
composition; bf16 within 2^-7 of each output's largest |value|: one bf16
rounding of the output, and of h, dyb and dab inside, after fp32 sums in
another order.

With dropout, the masks are the port's own: the plain backward against
autograd of the plain forward, the fused forward against the unfused MLP
of models/layers.py with the same seed (the same two masks), and the
masks' seeds, shapes and kept fraction.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops.mlp import _fused_mlp_core
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops import mlp as M

torch.set_num_threads(2)

N, DIM, HID = 48, 128, 256
BF16_TOL = 2.0 ** -7
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed=0, n=N, d=DIM, f=HID):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((n, d)),
                w1=rng.standard_normal((d, f)) / math.sqrt(d),
                b1=0.1 * rng.standard_normal(f),
                w2=rng.standard_normal((f, d)) / math.sqrt(f),
                b2=0.1 * rng.standard_normal(d),
                dy=rng.standard_normal((n, d)))


def _cast(inp: dict, dtype: str):
    """(jax arrays, torch tensors) in the kernel's dtypes: x, w1, w2 and dy
    in `dtype`, the biases fp32."""
    low = ("x", "w1", "w2", "dy")
    j = {k: jnp.asarray(v, dtype if k in low else jnp.float32)
         for k, v in inp.items()}
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        TORCH[dtype] if k in low else torch.float32) for k, v in j.items()}
    return j, t


def _close(got: torch.Tensor, want, dtype: str, atol_rtol: float):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=atol_rtol, atol=atol_rtol)
    else:
        gap = np.abs(got - want).max()
        assert gap <= BF16_TOL * np.abs(want).max(), gap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_matches_the_jax_kernel(dtype):
    """Forward and the five grads of `_fused_mlp_core` at rate 0 (interpret
    mode), against the plain versions and through `fused_mlp`'s autograd
    Function."""
    j, t = _cast(_inputs(), dtype)
    seed = jnp.zeros((2,), jnp.int32)
    y, vjp = jax.vjp(lambda x, w1, b1, w2, b2: _fused_mlp_core(
        x, w1, b1, w2, b2, seed, 0.0), j["x"], j["w1"], j["b1"], j["w2"],
        j["b2"])
    jgrads = vjp(j["dy"])

    args = [t[k] for k in ("x", "w1", "b1", "w2", "b2")]
    _close(M.fused_mlp_plain(*args, None, 0.0), y, dtype, 2e-5)
    plain = M.fused_mlp_bwd_plain(*args[:4], t["dy"], None, 0.0)
    leaves = [a.clone().requires_grad_() for a in args]
    out = M.fused_mlp(leaves[0], *leaves[1:], rate=0.0,
                      dtype=TORCH[dtype])
    _close(out, y, dtype, 2e-5)
    out.backward(t["dy"])
    for got, leaf, want in zip(plain, leaves, jgrads):
        _close(got, want, dtype, 2e-4)
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, want, dtype, 2e-4)


def test_plain_backward_matches_autograd_with_dropout():
    """fp32 at rate 0.1: the hand-written backward is autograd's, to
    summation order."""
    inp = _inputs(1)
    t = {k: torch.from_numpy(v).float() for k, v in inp.items()}
    seeds = M.mask_seeds(0.1, 77)
    leaves = [t[k].clone().requires_grad_()
              for k in ("x", "w1", "b1", "w2", "b2")]
    M.fused_mlp_plain(*leaves, seeds, 0.1).backward(t["dy"])
    got = M.fused_mlp_bwd_plain(t["x"], t["w1"], t["b1"], t["w2"], t["dy"],
                                seeds, 0.1)
    for g, leaf in zip(got, leaves):
        assert (g - leaf.grad).abs().max() <= 1e-5 * leaf.grad.abs().max()


def test_fused_matches_the_unfused_mlp_with_the_same_seed():
    """The two paths draw the same masks from one seed. fp32: the unfused
    composition with the tanh GELU gives the fused forward to 1e-6 of its
    scale (GELU's op order only). bf16: models/layers.mlp's unfused bf16
    path (what the CPU runs) within 2^-7, with the same zeros."""
    gen = torch.Generator().manual_seed(3)
    p = L.mlp_init(gen, DIM, HID / DIM)
    x = torch.from_numpy(_inputs(2)["x"]).float().reshape(4, 12, DIM)
    w1, b1 = p["fc1"].weight.T, p["fc1"].bias
    w2, b2 = p["fc2"].weight.T, p["fc2"].bias
    s1, s2 = D.split_seed(11, 2)
    with torch.no_grad():
        h = torch.nn.functional.gelu(L.linear(p["fc1"], x),
                                     approximate="tanh")
        want = D.dropout_plain(L.linear(p["fc2"], D.dropout_plain(
            h, 0.1, s1)), 0.1, s2)
        got = M.fused_mlp(x, w1, b1, w2, b2, 0.1, 11, torch.float32)
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()
        assert torch.equal(got == 0, want == 0)
        want = L.mlp(p, x, 0.1, 11, False, torch.bfloat16)
        got = M.fused_mlp(x, w1, b1, w2, b2, 0.1, 11, torch.bfloat16)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got == 0, want == 0)
    gap = (got.float() - want.float()).abs().max()
    assert gap <= BF16_TOL * want.float().abs().max()


@pytest.mark.parametrize("seed", [0, 5, 2 ** 40 + 3])
def test_mask_draws(seed):
    """m1 is the first split seed's keep_scale over (N, F), m2 the second's
    over (N, D); kept fractions within 4 sigma of 1 - rate; no dropout
    gives ones."""
    n, d, f, rate = 300, 128, 512, 0.1
    s1, s2 = D.split_seed(seed, 2)
    assert M.mask_seeds(rate, seed) == (s1, s2)
    m1, m2 = M.mlp_masks(n, d, f, (s1, s2), rate, "cpu")
    assert torch.equal(m1, D.keep_scale(s1, (n, f), rate))
    assert torch.equal(m2, D.keep_scale(s2, (n, d), rate))
    for m in (m1, m2):
        kept = (m != 0).double().mean().item()
        assert abs(kept - (1 - rate)) <= 4 * math.sqrt(
            rate * (1 - rate) / m.numel())
        assert set(m.unique().tolist()) == {0.0, np.float32(1 / (1 - rate))}
    assert M.mask_seeds(0.0, seed) is None
    ones = M.mlp_masks_plain(n, d, f, None, 0.0)
    assert all(bool((m == 1).all()) for m in ones)


@pytest.mark.parametrize("dtype,rate,det,device,d,f,want", [
    (torch.bfloat16, 0.1, False, "cuda", 256, 1024, True),
    (torch.float32, 0.1, False, "cuda", 256, 1024, False),
    (torch.bfloat16, 0.0, False, "cuda", 256, 1024, False),
    (torch.bfloat16, 0.1, True, "cuda", 256, 1024, False),
    (torch.bfloat16, 0.1, False, "cpu", 256, 1024, False),
    (torch.bfloat16, 0.1, False, "cuda", 192, 768, False),
    (torch.bfloat16, 0.1, False, "cuda", 128, 320, False)])
def test_routing_rule(dtype, rate, det, device, d, f, want):
    """The JAX package's rule (mmd_tpu/models/layers.py:121-128) with CUDA
    tensors for the TPU."""
    assert L.needs_fused_mlp(dtype, rate, det, torch.device(device), d,
                             f) is want


def test_layers_mlp_takes_fused_mlp_where_the_rule_holds(monkeypatch):
    """Where the rule holds, layers.mlp is fused_mlp (here on CPU tensors,
    so its plain version) on the layer's params in the JAX layout."""
    p = L.mlp_init(torch.Generator().manual_seed(4), DIM, 2.0)
    x = torch.randn(3, 7, DIM)
    monkeypatch.setattr(L, "needs_fused_mlp", lambda *a: True)
    got = L.mlp(p, x, 0.1, 9, False, torch.bfloat16)
    s = M.mask_seeds(0.1, 9)
    want = M.fused_mlp_plain(
        x.reshape(-1, DIM).bfloat16(), p["fc1"].weight.T.bfloat16(),
        p["fc1"].bias, p["fc2"].weight.T.bfloat16(), p["fc2"].bias, s, 0.1)
    assert torch.equal(got, want.reshape(x.shape))


def test_fused_mlp_refuses_what_is_not_ported():
    x, w1, b1 = torch.randn(4, DIM), torch.randn(DIM, HID), torch.zeros(HID)
    w2, b2 = torch.randn(HID, DIM), torch.zeros(DIM)
    with pytest.raises(NotImplementedError, match="A16"):
        M.fused_mlp(x, w1, b1, w2, b2, 0.1, 1, tp_mesh=object())
    with pytest.raises(ValueError, match="seed"):
        M.fused_mlp(x, w1, b1, w2, b2, 0.1, None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        M.fused_mlp_fwd(x.to("meta"), w1, b1, w2, b2, None, 0.0)


@pytest.mark.parametrize("n", [1, 64, 65, 1000, 1088, 16384, 131072])
def test_backward_groups_cover_the_rows(n):
    """The backward's weight pass: at most 16 groups of whole 64-row tiles,
    none empty, together covering every row."""
    groups, rows = M.backward_groups(n)
    assert 1 <= groups <= 16 and rows % 64 == 0
    assert (groups - 1) * rows < n <= groups * rows
