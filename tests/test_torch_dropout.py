"""Port dropout (mmd_tpu_torch/ops/dropout.py, models/layers.py) on the CPU.

The JAX package draws its masks from the TPU's on-chip PRNG, which has no
interpret mode, or from jax.random.bernoulli off the TPU: no mask of the
port can be held against a JAX mask. What is checked instead is the
generator itself -- Philox4x32-10 against the Random123 known-answer
vectors -- the kept fraction against 1 - rate within 4 sigma, the mask's
dependence on (seed, index) alone, and the backward (dx = g * keep *
scale, exactly). The CUDA kernel is held bit for bit against
`dropout_plain` in tests/test_torch_cuda.py, which needs a card.
"""

import math

import numpy as np
import pytest
import torch

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import dropout as D

torch.set_num_threads(2)

M32 = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32_10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answer(ctr, key, want):
    words = [torch.tensor([c], dtype=torch.int64) for c in ctr]
    got = D.philox4x32(*words, key[0] | (key[1] << 32))
    assert tuple(int(w) for w in got) == want


def test_random_bits_are_lanes_of_group_draws():
    """Element i is lane i & 3 of the draw for counter i >> 2."""
    seed = 0x0123456789ABCDEF
    bits = D.random_bits(seed, 23)
    for i in (0, 3, 4, 13, 22):
        g = torch.tensor([i >> 2], dtype=torch.int64)
        z = torch.zeros_like(g)
        words = D.philox4x32(g, z, z, z, seed)
        assert int(bits[i]) == int(words[i & 3])
    assert bool((bits >= 0).all()) and bool((bits <= M32).all())


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_kept_fraction_within_4_sigma(rate):
    n = 1 << 20
    kept = (D.keep_scale(7, (n,), rate) != 0).double().mean().item()
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(kept - (1 - rate)) < 4 * sigma


def test_threshold_matches_the_tpu_kernels():
    assert D.threshold(0.1) == min(int(0.9 * 4294967296.0), 4294967295)
    assert D.threshold(1e-12) == 4294967295


def test_mask_depends_on_seed_and_flat_index_only():
    x = torch.randn(6, 40)
    y = D.dropout_plain(x, 0.3, 11)
    flat = D.dropout_plain(x.reshape(-1), 0.3, 11).reshape(6, 40)
    assert torch.equal(y, flat)
    assert torch.equal(y, D.dropout_plain(x.reshape(3, 80), 0.3, 11
                                          ).reshape(6, 40))
    assert not torch.equal(y, D.dropout_plain(x, 0.3, 12))
    ks = D.keep_scale(11, (6, 40), 0.3)
    assert torch.equal(y, x * ks)
    assert set(ks.unique().tolist()) == {0.0, np.float32(1 / 0.7).item()}


def test_bf16_rounds_once():
    x = torch.randn(8, 33).to(torch.bfloat16)
    y = D.dropout_plain(x, 0.2, 5)
    want = (x.float() * D.keep_scale(5, x.shape, 0.2)).to(torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)


def test_backward_is_keep_scale():
    """dx = g * keep * scale exactly: the backward regenerates the mask."""
    x = torch.randn(5, 24, requires_grad=True)
    g = torch.randn(5, 24)
    D.dropout(x, 0.25, 99).backward(g)
    assert torch.equal(x.grad, g * D.keep_scale(99, (5, 24), 0.25))


def test_cpu_runs_the_plain_version_without_a_launch():
    x = torch.randn(4, 10)
    before = D.launches
    assert torch.equal(D.dropout(x, 0.1, 3), D.dropout_plain(x, 0.1, 3))
    assert D.launches == before


def test_bad_rates_raise():
    for rate in (0.0, 1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            D.dropout(torch.ones(4), rate, 0)


def test_split_seed_gives_distinct_seeds():
    seeds = D.split_seed(123, 6)
    assert len(set(seeds)) == 6 and all(0 <= s < 2 ** 64 for s in seeds)
    assert seeds == D.split_seed(123, 6)
    assert D.split_seed(124, 6) != seeds


def test_layers_dropout_routing():
    x = torch.randn(3, 16)
    assert L.dropout(x, 0.1, None, deterministic=True) is x
    assert L.dropout(x, 0.0, None, deterministic=False) is x
    with pytest.raises(ValueError, match="seed"):
        L.dropout(x, 0.1, None, deterministic=False)
    assert torch.equal(L.dropout(x, 0.1, 4, False),
                       D.dropout_plain(x, 0.1, 4))


def test_mlp_and_head_draw_one_mask_per_site():
    """The MLP's two dropouts and a head's dropouts take seeds split from
    the site's seed: reproducible, and different from each other."""
    gen = torch.Generator().manual_seed(0)
    mlp = L.mlp_init(gen, 16, 4.0)
    x = torch.randn(5, 16)
    a = L.mlp(mlp, x, 0.5, 77, deterministic=False)
    assert torch.equal(a, L.mlp(mlp, x, 0.5, 77, deterministic=False))
    assert not torch.equal(a, L.mlp(mlp, x, 0.5, 78, deterministic=False))
    s1, s2 = D.split_seed(77, 2)
    h = torch.nn.functional.gelu(L.linear(mlp["fc1"], x))
    h = L.linear(mlp["fc2"], D.dropout_plain(h, 0.5, s1))
    assert torch.equal(a, D.dropout_plain(h, 0.5, s2))
    head = L.head_init(gen, [16, 8, 8, 3])
    assert torch.equal(L.head_apply(head, x, 0.5, 9, False),
                       L.head_apply(head, x, 0.5, 9, False))
    assert torch.equal(L.head_apply(head, x, 0.5, None, True),
                       L.head_apply(head, x))


def test_bf16_mlp_with_dropout_runs_unfused_on_the_cpu():
    """Off CUDA, bf16 with dropout takes the unfused MLP, as the JAX package
    does off the TPU; on CUDA tensors the same call is the fused-MLP path,
    the kernels of ops/mlp.py (tests/test_torch_mlp.py,
    tests/test_torch_cuda.py)."""
    gen = torch.Generator().manual_seed(1)
    mlp = L.mlp_init(gen, 128, 4.0)
    x = torch.randn(4, 128).to(torch.bfloat16)
    y = L.mlp(mlp, x, 0.1, 5, deterministic=False, dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert L.needs_fused_mlp(torch.bfloat16, 0.1, False,
                             torch.device("cuda"), 128, 512)
    assert not L.needs_fused_mlp(torch.float32, 0.1, False,
                                 torch.device("cuda"), 128, 512)
    assert not L.needs_fused_mlp(torch.bfloat16, 0.1, True,
                                 torch.device("cuda"), 128, 512)
    assert not L.needs_fused_mlp(torch.bfloat16, 0.1, False,
                                 torch.device("cuda"), 64, 256)
    assert not L.needs_fused_mlp(torch.bfloat16, 0.1, False,
                                 torch.device("cpu"), 128, 512)
