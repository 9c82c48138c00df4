"""The fusion model at the CLI's wider widths (`--embed_dim 384|512
--num_heads 4`) against the JAX package, on the CPU.

Flash attention (#1/#2) now takes every head dim that is a multiple of 16
from 32 to 128 (dh 48, 80, 96 and 112 beside 32, 64 and 128), and the fused
MLP (#3/#4) every D that is a multiple of 128 up to 1024, the wider D on a
design of their own: the forward in two launches through an (N, F)
workspace, the backward's first pass with x and dyb streamed along D. The
CUDA kernels need a card (tests/test_torch_cuda.py); here the plain
versions the wrappers take for CPU tensors are held against the JAX
package's Pallas kernels in interpret mode, at rate 0 (the TPU PRNG behind
their masks has no interpret mode), and the new order of work of #3/#4 is
mirrored in PyTorch and held against the plain versions. The fusion
model's step and forward at these widths are in
tests/test_torch_wide_step.py.

Tolerances:
  * flash forward and backward, fp32: 2e-5 absolute and relative, as
    tests/test_torch_attention.py holds dh 32 and 64 (fp32 sums in another
    order);
  * MLP: fp32 within 2e-5 (forward) and 2e-4 (grads), bf16 within 2^-7 of
    each output's largest |value|, as tests/test_torch_mlp.py holds D 128;
  * the order-of-work mirrors: fp32 within 1e-5 of each output's largest
    |value| (fp32 summation order), bf16 forward within one bf16 step at
    the largest |y|, as tests/test_torch_mlp_fwd_mirror.py holds the
    one-kernel forward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmd_tpu.ops import attention as jattn
from mmd_tpu.ops.mlp import _fused_mlp_core
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import attention as A
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops import mlp as M

torch.set_num_threads(2)

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = 2.0 ** -7
WIDE = [(384, 1536), (512, 2048)]       # the CLI's D and F = 4 D
WIDTHS = [384, 512]


def _t(x):
    return None if x is None else torch.from_numpy(x)


# -- flash attention at the new head dims ----------------------------------------

def _attn_inputs(t, s, dh, seed):
    rng = np.random.default_rng(seed)
    b, h = 3, 2
    q, k, v, do = (rng.standard_normal((b, n, h * dh)).astype(np.float32)
                   for n in (t, s, s, t))
    mask = np.ones((b, s), np.float32)
    mask[1, s // 2 + 1:] = 0.0          # a padded row
    mask[2] = 0.0                       # a row with no valid key
    return q, k, v, do, mask, h


@pytest.mark.parametrize("t,s", [(64, 64), (16, 40)])
@pytest.mark.parametrize("dh", [48, 96, 112])
def test_plain_flash_matches_the_jax_kernel_at_new_head_dims(dh, t, s):
    """The port's plain forward (o, natural-log lse) and backward against
    JAX's _flash_fwd and the VJP of its masked core (_flash_bwd), Pallas in
    interpret mode, with a key mask, rate 0, fp32; lse where the row has a
    valid key (JAX keeps a finite sentinel there, the port -inf)."""
    q, k, v, do, mask, h = _attn_inputs(t, s, dh, seed=dh + t)
    kb = jnp.asarray((1.0 - mask) * -1e9)
    seed = jnp.zeros((1,), jnp.int32)
    o_j, lse2 = jattn._flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), seed, h, 0.0, kb=kb)
    _, vjp = jax.vjp(lambda a, b, c: jattn._fused_attention_core_masked(
        a, b, c, kb, seed, h, 0.0), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tm = _t(q), _t(k), _t(v), _t(mask)
    o, lse = A.flash_attention_plain(tq, tk, tv, h, tm)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **ATTN_TOL)
    np.testing.assert_allclose(lse.numpy()[:2],
                               np.asarray(lse2)[:2] * math.log(2.0),
                               **ATTN_TOL)
    assert np.all(np.isneginf(lse.numpy()[2])) and np.all(o.numpy()[2] == 0)
    got = A.flash_attention_bwd_plain(tq, tk, tv, o, lse, _t(do), h, tm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ATTN_TOL)


# -- the fused MLP at D 384 and 512 ---------------------------------------------

def _mlp_inputs(n, d, f, seed):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((n, d)),
                w1=rng.standard_normal((d, f)) / math.sqrt(d),
                b1=0.1 * rng.standard_normal(f),
                w2=rng.standard_normal((f, d)) / math.sqrt(f),
                b2=0.1 * rng.standard_normal(d),
                dy=rng.standard_normal((n, d)))


def _mlp_cast(inp: dict, dtype: str):
    low = ("x", "w1", "w2", "dy")
    j = {k: jnp.asarray(v, dtype if k in low else jnp.float32)
         for k, v in inp.items()}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    t = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        tdt if k in low else torch.float32) for k, v in j.items()}
    return j, t


def _mlp_close(got: torch.Tensor, want, dtype: str, tol: float):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        gap = np.abs(got - want).max()
        assert gap <= BF16_TOL * np.abs(want).max(), gap


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f", WIDE)
def test_fused_mlp_matches_the_jax_kernel_at_wide_d(d, f, dtype):
    """Forward and the five grads of `_fused_mlp_core` at rate 0 (interpret
    mode), 40 rows, against the plain versions and through `fused_mlp`'s
    autograd Function."""
    j, t = _mlp_cast(_mlp_inputs(40, d, f, seed=d), dtype)
    seed = jnp.zeros((2,), jnp.int32)
    y, vjp = jax.vjp(lambda x, w1, b1, w2, b2: _fused_mlp_core(
        x, w1, b1, w2, b2, seed, 0.0), j["x"], j["w1"], j["b1"], j["w2"],
        j["b2"])
    jgrads = vjp(j["dy"])
    args = [t[k] for k in ("x", "w1", "b1", "w2", "b2")]
    _mlp_close(M.fused_mlp_plain(*args, None, 0.0), y, dtype, 2e-5)
    plain = M.fused_mlp_bwd_plain(*args[:4], t["dy"], None, 0.0)
    leaves = [a.clone().requires_grad_() for a in args]
    out = M.fused_mlp(leaves[0], *leaves[1:], rate=0.0, dtype=args[0].dtype)
    _mlp_close(out, y, dtype, 2e-5)
    out.backward(t["dy"])
    for got, leaf, want in zip(plain, leaves, jgrads):
        _mlp_close(got, want, dtype, 2e-4)
        assert leaf.grad.dtype == leaf.dtype
        _mlp_close(leaf.grad, want, dtype, 2e-4)


# -- the order of work of #3 and #4 above D 256 ---------------------------------
# A mirror, in PyTorch, of the two-launch forward (mlp_fwd.cu) and of the
# backward's passes A0 and A1 (mlp_bwd.cu), on 128 x 128 tiles of
# mlp_tile.cuh: a tile sums its contraction in stages of 64, in order; a
# tile's keep bits are drawn a byte per 8 columns at the absolute index
# (mlp_common.cuh fill_keep) and read back bit by bit; GELU is
# mlp_common.cuh's 1 - 2 / (1 + e^2u) tanh. Passes B and C are those of
# tests/test_torch_mlp.py's mirror: the weight products by the row groups of
# `backward_groups`, dx by 128-row tiles over the whole of F, the fixed-order
# sums.

BT, BKW = 128, 64


def _gelu_fast_and_grad(a: torch.Tensor):
    u = M._C * (a + M._K * a * a * a)
    t = 1.0 - 2.0 / (1.0 + torch.exp(2.0 * u))
    g = 0.5 * a * (1.0 + t)
    dg = 0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * M._C * (
        1.0 + 3.0 * M._K * a * a)
    return g, dg


def _keep_tile(seed, rate: float, row0: int, ld: int, c0: int) -> torch.Tensor:
    """keep * scale of a BT x BT tile of a (rows, ld) mask at (row0, c0):
    bytes of 8 columns from the Philox draws at the absolute index, then
    bit c % 8 of byte c / 8."""
    if seed is None:
        return torch.ones(BT, BT)
    r = torch.arange(BT, dtype=torch.int64)[:, None] + row0
    idx = r * ld + c0 + torch.arange(BT, dtype=torch.int64)
    group = idx >> 2
    words = D.philox4x32(group & 0xFFFFFFFF, group >> 32,
                         torch.zeros_like(group), torch.zeros_like(group),
                         seed)
    bits = torch.stack(words, -1).gather(-1, (idx & 3)[..., None])[..., 0]
    keep = (bits < D.threshold(rate)).to(torch.int64)
    packed = (keep.reshape(BT, BT // 8, 8)
              << torch.arange(8, dtype=torch.int64)).sum(-1)
    col = torch.arange(BT)
    read = (packed[:, col // 8] >> (col % 8)) & 1
    return read.float() * torch.tensor(1.0 / (1.0 - rate))


def _tile_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (BT, K) b (K, BT) in fp32, the contraction in stages of 64 in
    order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], BKW):
        acc = acc + a[:, k0:k0 + BKW] @ b[k0:k0 + BKW]
    return acc


def _rows(x: torch.Tensor, row0: int) -> torch.Tensor:
    """The tile's BT rows of x from row0, missing rows zero."""
    out = torch.zeros(BT, x.shape[1])
    real = min(BT, x.shape[0] - row0)
    out[:real] = x[row0:row0 + real].float()
    return out


def wide_forward_mirror(x2, w1, b1, w2, b2, seeds, rate):
    n, d = x2.shape
    f = w1.shape[1]
    s1, s2 = seeds if seeds is not None else (None, None)
    w1f, w2f = w1.float(), w2.float()
    h = torch.zeros(n, f)
    for row0 in range(0, n, BT):                # launch 1: h, tile by tile
        real = min(BT, n - row0)
        xt = _rows(x2, row0)
        for c0 in range(0, f, BT):
            a = _tile_product(xt, w1f[:, c0:c0 + BT]) + b1[c0:c0 + BT].float()
            ht = _gelu_fast_and_grad(a)[0] * _keep_tile(s1, rate, row0, f, c0)
            h[row0:row0 + real, c0:c0 + BT] = ht[:real].to(x2.dtype).float()
    y = torch.empty(n, d, dtype=x2.dtype)
    for row0 in range(0, n, BT):                # launch 2: y over F in order
        real = min(BT, n - row0)
        ht = _rows(h, row0)
        for c0 in range(0, d, BT):
            yt = (_tile_product(ht, w2f[:, c0:c0 + BT]) + b2[c0:c0 + BT].float()
                  ) * _keep_tile(s2, rate, row0, d, c0)
            y[row0:row0 + real, c0:c0 + BT] = yt[:real].to(x2.dtype)
    return y


def _slices(parts: torch.Tensor, slices: int) -> torch.Tensor:
    """Rows s, s + slices, ... of each slice in order, then the slices in
    order."""
    sums = [torch.zeros(parts.shape[1]) for _ in range(slices)]
    for r in range(parts.shape[0]):
        sums[r % slices] = sums[r % slices] + parts[r]
    total = torch.zeros(parts.shape[1])
    for s in sums:
        total = total + s
    return total


def wide_backward_mirror(x2, w1, b1, w2, dy, seeds, rate):
    n, d = x2.shape
    f = w1.shape[1]
    dtype = x2.dtype
    s1, s2 = seeds if seeds is not None else (None, None)
    w1f, w2f = w1.float(), w2.float()
    tiles = -(-n // BT)
    dyb = torch.zeros(n, d)
    db2_parts = torch.zeros(tiles, d)
    for t in range(tiles):                      # A0: by (tile, 128 columns)
        row0, real = t * BT, min(BT, n - t * BT)
        for c0 in range(0, d, BT):
            dyf = _rows(dy, row0)[:, c0:c0 + BT] * _keep_tile(
                s2, rate, row0, d, c0)
            dyf[real:] = 0.0
            dyb[row0:row0 + real, c0:c0 + BT] = dyf[:real].to(dtype).float()
            # 16 row slices (rows r = slice mod 16), each in row order,
            # then the slices in order
            db2_parts[t, c0:c0 + BT] = _slices(dyf, 16)
    hb, dab = torch.zeros(n, f), torch.zeros(n, f)
    db1_parts = torch.zeros(tiles, f)
    for t in range(tiles):                      # A1: by (tile, 128 hidden)
        row0, real = t * BT, min(BT, n - t * BT)
        xt, dyt = _rows(x2, row0), _rows(dyb, row0)
        for c0 in range(0, f, BT):
            a = _tile_product(xt, w1f[:, c0:c0 + BT]) + b1[c0:c0 + BT].float()
            dh = _tile_product(dyt, w2f[c0:c0 + BT].T)
            k = _keep_tile(s1, rate, row0, f, c0)
            g, dg = _gelu_fast_and_grad(a)
            da = dh * k * dg
            hb[row0:row0 + real, c0:c0 + BT] = (g * k)[:real].to(dtype).float()
            dab[row0:row0 + real, c0:c0 + BT] = da[:real].to(dtype).float()
            part = torch.zeros(BT)
            for w in range(BT // 16):           # the 8 warps' sums, in order
                part = part + da[16 * w:16 * w + 16].sum(0)
            db1_parts[t, c0:c0 + BT] = part
    groups, group_rows = M.backward_groups(n)
    dw1, dw2 = torch.zeros(d, f), torch.zeros(f, d)
    for g in range(groups):                     # B, then C's group sums
        r0, r1 = g * group_rows, min(n, (g + 1) * group_rows)
        dw1 = dw1 + x2[r0:r1].float().T @ dab[r0:r1]
        dw2 = dw2 + hb[r0:r1].T @ dyb[r0:r1]
    dx = torch.cat([(dab[r0:r0 + BT] @ w1f.T).to(dtype)
                    for r0 in range(0, n, BT)])
    return dx, dw1, _slices(db1_parts, 32), dw2, _slices(db2_parts, 32)


def _wide_inputs(n, d, f, seed):
    inp = _mlp_inputs(n, d, f, seed)
    return {k: torch.from_numpy(v).float() for k, v in inp.items()}


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want.double()).abs().max().item()


MIRROR = [(1, 384, 512), (200, 384, 1536), (130, 512, 640)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,d,f", MIRROR)
def test_wide_forward_order_of_work_matches_plain(n, d, f, rate):
    t = _wide_inputs(n, d, f, seed=n + d)
    args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    seeds = M.mask_seeds(rate, 4321 + n)
    got = wide_forward_mirror(*args, seeds, rate)
    want = M.fused_mlp_plain(*args, seeds, rate)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _gap(got, want) <= 1e-5 * want.abs().max().item()
    assert torch.equal(got == 0, want == 0) or rate == 0.0


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_forward_order_of_work_in_bf16(rate):
    """bf16 inputs, h and y rounded where the kernels round them: within
    one bf16 step at the largest |y| (an h that rounds the other way after
    fp32 sums in another order, then y's own rounding)."""
    t = _wide_inputs(200, 384, 1536, seed=5)
    x, w1, w2 = (t[k].to(torch.bfloat16) for k in ("x", "w1", "w2"))
    seeds = M.mask_seeds(rate, 99)
    got = wide_forward_mirror(x, w1, t["b1"], w2, t["b2"], seeds, rate)
    want = M.fused_mlp_plain(x, w1, t["b1"], w2, t["b2"], seeds, rate)
    assert got.dtype == want.dtype == torch.bfloat16
    peak = want.float().abs().max().item()
    step = 2.0 ** (math.floor(math.log2(peak)) - 7)
    assert _gap(got, want) <= step, (_gap(got, want), step)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("n,d,f", MIRROR)
def test_wide_backward_order_of_work_matches_plain(n, d, f, rate):
    t = _wide_inputs(n, d, f, seed=3 * n + d)
    args = (t["x"], t["w1"], t["b1"], t["w2"], t["dy"])
    seeds = M.mask_seeds(rate, 1234 + n)
    got = wide_backward_mirror(*args, seeds, rate)
    want = M.fused_mlp_bwd_plain(*args, seeds, rate)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert g.shape == w.shape, name
        assert _gap(g, w) <= 1e-5 * w.abs().max().item(), name


def test_wide_forward_mirror_matches_the_jax_kernel_at_rate_0():
    t = _wide_inputs(130, 512, 640, seed=11)
    args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"])
    want = np.array(_fused_mlp_core(*(jnp.asarray(a.numpy()) for a in args),
                                    jnp.zeros((2,), jnp.int32), 0.0))
    got = wide_forward_mirror(*args, None, 0.0)
    assert _gap(got, torch.from_numpy(want)) <= 2e-5 * np.abs(want).max()


def test_wide_keep_tiles_are_the_plain_masks():
    """A tile's keep bits, drawn a byte per 8 columns at (row0, c0) and read
    back bit by bit, are mlp_masks_plain's masks there."""
    n, d, f, rate = 256, 384, 512, 0.1
    seeds = M.mask_seeds(rate, 6)
    m1, m2 = M.mlp_masks_plain(n, d, f, seeds, rate)
    for row0 in (0, 128):
        for c0 in range(0, f, BT):
            assert torch.equal(_keep_tile(seeds[0], rate, row0, f, c0),
                               m1[row0:row0 + BT, c0:c0 + BT])
        for c0 in range(0, d, BT):
            assert torch.equal(_keep_tile(seeds[1], rate, row0, d, c0),
                               m2[row0:row0 + BT, c0:c0 + BT])


# -- the routing rules at these widths -------------------------------------------

@pytest.mark.parametrize("embed", WIDTHS)
def test_the_wide_step_routes_every_attention_and_mlp_to_the_kernels(embed):
    """At `--embed_dim 384|512 --num_heads 4` in bf16 with dropout, on a
    CUDA device, both rules send the step to the kernels: flash attention
    at dh 96 / 128 and the fused MLP at D, F = 4 D."""
    assert A.fused_ok(embed, 4) and embed // 4 in A._HEAD_DIMS
    assert L.needs_fused_mlp(torch.bfloat16, 0.1, False,
                             torch.device("cuda"), embed, 4 * embed)
    x = torch.zeros(8, embed)
    M._check_kernel_inputs(x.bfloat16(), torch.zeros(
        embed, 4 * embed).bfloat16(), torch.zeros(4 * embed), torch.zeros(
        4 * embed, embed).bfloat16(), torch.zeros(embed))
