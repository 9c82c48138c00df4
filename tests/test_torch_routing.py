"""The port's attention routing rules admit only what their kernels take.

Each rule that sends a geometry to a hand-written kernel -- flash attention
(`ops.attention.fused_ok`, read by `multi_head_attention`), Swin window
attention (`ops.swin_attention.fused_ok`, read by `models.swin._block`)
and DeBERTa disentangled attention (`models.deberta.use_fused_attn`) -- is
held against that kernel's own input checks over a grid of geometries:
where the rule says yes, the checks accept. Flash attention's rule is the
JAX rule (every head dim from 32 up) except above head dim 128 and off the
multiples of 16, which take the explicit path (ROADMAP §C); head dims 96
(the fusion CLI's `--embed_dim 384 --num_heads 4`) and 128 (FakeNet's 2
heads of 128, `--embed_dim 512 --num_heads 4`) take the flash kernels.
Where the JAX package's rule admits more (Swin head dim 128, DeBERTa head
dims other than 32 and 64), the port's rule is the JAX rule narrowed to
the kernels' geometries, and those blocks take the explicit path, which
draws the same dropout masks; Swin's 16 x 16, 24 x 24 and 32 x 32 windows
take the kernels, as in the JAX package. Under tensor parallelism the DeBERTa rule
reads the model's geometry and the kernel receives the rank's heads, which
its checks accept.
"""

import dataclasses
import itertools

import pytest
import torch

from mmd_tpu.models import swin as JS
from mmd_tpu_torch.models import deberta as TD
from mmd_tpu_torch.ops import attention as A
from mmd_tpu_torch.ops import deberta_attention as DA
from mmd_tpu_torch.ops import swin_attention as SA


def _accepts(check, *args) -> bool:
    try:
        check(*args)
    except ValueError:
        return False
    return True


# -- flash attention: (D, heads) -------------------------------------------------

@pytest.mark.parametrize("d,heads", list(itertools.product(
    (64, 96, 128, 192, 256, 320, 384, 448, 512, 1024),
    (1, 2, 3, 4, 6, 8, 16))))
def test_flash_rule_admits_only_what_the_kernel_takes(d, heads):
    """The rule is the kernels' checks, and it is the JAX rule (head dim
    32 and up) but for head dims above 128 or off the multiples of 16."""
    q = torch.zeros(1, 16, d)
    ok = A.fused_ok(d, heads)
    assert ok == (_accepts(A._check_kernel_inputs, q, q, q, heads, None)
                  and d // heads >= 32)
    dh = d // heads
    jax_rule = d % heads == 0 and dh >= 32
    assert ok == (jax_rule and dh <= 128 and dh % 16 == 0)


def _fused_and_explicit(d, heads):
    """multi_head_attention's fused and explicit routes on the same inputs,
    a padded key tail and dropout on."""
    g = torch.Generator().manual_seed(d + heads)
    q, k, v = (torch.randn(2, 24, d, generator=g) for _ in range(3))
    mask = torch.ones(2, 24, dtype=torch.int32)
    mask[1, 17:] = 0

    def run(fused):
        return A.multi_head_attention(q, k, v, heads, dropout_rate=0.1,
                                      dropout_seed=9, deterministic=False,
                                      fused=fused, key_mask=mask)

    return run(True), run(False)


@pytest.mark.parametrize("d,heads", [(384, 4), (192, 4), (320, 4),
                                     (448, 4), (768, 8)])
def test_flash_rule_sends_dh_96_to_the_kernels(d, heads):
    """The CLI's `--embed_dim 384 --num_heads 4` (dh 96), and dh 48, 80 and
    112: the rule admits them as the JAX rule does, the kernels' checks
    accept them, and the fused route on the CPU (the kernels' plain
    versions, the same dropout masks) gives the explicit path's output to
    fp32 summation order."""
    assert A.fused_ok(d, heads)
    q = torch.zeros(2, 24, d)
    assert _accepts(A._check_kernel_inputs, q, q, q, heads,
                    torch.ones(2, 24, dtype=torch.int32))
    fused, explicit = _fused_and_explicit(d, heads)
    assert (fused - explicit).abs().max().item() <= 1e-5 * \
        explicit.abs().max().item()


@pytest.mark.parametrize("d,heads", [(1024, 4), (576, 4), (160, 4),
                                     (200, 5)])
def test_flash_rule_keeps_dh_above_128_or_off_16_explicit(d, heads):
    """The two divergences from the JAX rule that remain (ROADMAP §C): a
    head dim above 128 (256, 144) or not a multiple of 16 (40), which the
    JAX rule sends to its kernel, takes the explicit path: the fused route
    gives the explicit path's output, and no kernel (which would raise on a
    card) is asked."""
    assert d // heads >= 32 and not A.fused_ok(d, heads)
    fused, explicit = _fused_and_explicit(d, heads)
    assert torch.equal(fused, explicit)


@pytest.mark.parametrize("d,heads", [(512, 4), (256, 2), (384, 3)])
def test_flash_rule_admits_dh_128(d, heads):
    """`--embed_dim 512 --num_heads 4` and FakeNet's 2 heads of 128: the
    rule admits them, the kernels' checks accept them, and the fused route
    on the CPU (the kernels' plain versions, the same dropout masks) gives
    the explicit path's output to fp32 summation order."""
    assert A.fused_ok(d, heads)
    q = torch.zeros(2, 24, d)
    assert _accepts(A._check_kernel_inputs, q, q, q, heads,
                    torch.ones(2, 24, dtype=torch.int32))
    fused, explicit = _fused_and_explicit(d, heads)
    assert (fused - explicit).abs().max().item() <= 1e-5 * \
        explicit.abs().max().item()


# -- Swin window attention: (window, dh, heads) --------------------------------

SWIN_GRID = list(itertools.product((4, 7, 8, 12, 16, 24), (16, 32, 48, 64,
                                                           96, 128),
                                   (1, 2, 3, 4, 8)))


@pytest.mark.parametrize("window,dh,heads", SWIN_GRID)
def test_swin_rule_admits_only_what_the_kernels_take(window, dh, heads):
    """fused_ok is the JAX rule where #7 (serving) and #8/#9 (fine-tuning)
    accept the geometry, and False elsewhere."""
    n, c = window * window, dh * heads
    q = torch.zeros(1, 2, n, c)
    bias = torch.zeros(1, heads, n, n)
    serve = _accepts(SA._check_kernel_inputs, q, q, q, bias,
                     torch.zeros(heads), heads)
    train = _accepts(SA._check_train_inputs, q, q, q, bias, heads)
    assert SA.fused_ok(window, dh, heads) == (
        JS._fused_ok(window, dh, heads) and serve and train)


def test_swin_window_16_takes_the_explicit_path():
    """A 16 x 16 window takes the explicit path only where the port's rule
    still narrows the JAX rule: head dim 128 (fused_ok(16, 128, 2)), which
    the JAX rule admits and kernels #7-#9 do not take. At head dims 32 and
    64 it takes the kernels (256 tokens), as at 8 x 8 (64)."""
    assert JS._fused_ok(16, 128, 2)
    assert not SA.fused_ok(16, 128, 2)
    for window, dh, heads in ((16, 32, 4), (16, 64, 2), (8, 32, 4)):
        assert JS._fused_ok(window, dh, heads)
        assert SA.fused_ok(window, dh, heads)


@pytest.mark.parametrize("window,dh,heads", list(itertools.product(
    (4, 8, 12, 16, 24, 32), (16, 32, 64, 128), (1, 2, 3, 4, 6, 8, 16, 32))))
def test_swin_rule_is_the_jax_rule_but_at_dh_128(window, dh, heads):
    """The port's fused_ok equals the JAX package's _fused_ok -- windows 8,
    16, 24 (where the head group is even) and 32 at head dims 32 and 64 --
    with one exception, named here: head dim 128, which the JAX rule
    admits and the kernels do not take (ROADMAP §C)."""
    jax_rule = JS._fused_ok(window, dh, heads)
    if dh == 128:
        assert not SA.fused_ok(window, dh, heads)
    else:
        assert SA.fused_ok(window, dh, heads) == jax_rule


# -- DeBERTa disentangled attention: (D, heads, T) -------------------------------

@pytest.mark.parametrize("d,heads,t", list(itertools.product(
    (128, 256, 384, 512), (2, 3, 4, 6, 8), (32, 64, 128))))
def test_deberta_rule_admits_only_what_the_kernels_take(d, heads, t):
    cfg = dataclasses.replace(TD.DEBERTA_TEST, hidden_size=d, num_heads=heads)
    q = torch.zeros(1, t, d)
    tab = torch.zeros(2 * t, d)
    mask = torch.ones(1, t, dtype=torch.uint8)
    accepted = _accepts(DA._check_kernel_inputs, q, q, q, tab, tab, mask,
                        heads)
    rule = TD.use_fused_attn(cfg, t, torch.device("cuda"))
    assert not rule or accepted
    # the JAX gate (D and 2T multiples of 128) narrowed to the kernels
    assert rule == (d % 128 == 0 and (2 * t) % 128 == 0 and accepted)


@pytest.mark.parametrize("tp", [1, 2, 3, 6])
def test_deberta_rule_under_tp_reads_the_model_and_the_local_geometry(tp):
    """Under tensor parallelism a rank hands #10 its h/tp heads of the same
    head dim: DeBERTa-v3-xsmall at TP 2 is 3 heads of 64, D 192, no
    multiple of 128. The gate reads the model's width and head dim, as the
    JAX gate reads the unsplit width (the JAX package's GSPMD path runs no
    kernel; the port runs it device-locally, as a shard_map would), and
    the kernel's own checks accept the local geometry it then receives."""
    from types import SimpleNamespace

    from mmd_tpu_torch.parallel.tp import TensorParallel
    cfg, t = TD.DEBERTA_V3_XSMALL, 512
    mesh = SimpleNamespace(shape={"data": 1, "model": tp},
                           axis_index=lambda axis: tp - 1)
    local = TensorParallel(mesh).local_config(cfg)
    assert (local.num_heads, local.hidden_size) == (6 // tp, 384 // tp)
    assert local.hidden_size // local.num_heads == 64
    assert TD.use_fused_attn(cfg, t, torch.device("cuda"))
    q = torch.zeros(1, t, local.hidden_size)
    tab = torch.zeros(2 * t, local.hidden_size)
    assert _accepts(DA._check_kernel_inputs, q, q, q, tab, tab,
                    torch.ones(1, t, dtype=torch.uint8), local.num_heads)


def test_deberta_dh_128_takes_the_explicit_path():
    cfg = dataclasses.replace(TD.DEBERTA_V3_XSMALL, hidden_size=384,
                              num_heads=3)
    assert not TD.use_fused_attn(cfg, 256, torch.device("cuda"))
    assert TD.use_fused_attn(TD.DEBERTA_V3_XSMALL, 256, torch.device("cuda"))
