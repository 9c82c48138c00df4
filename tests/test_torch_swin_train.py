"""The Swin fine-tuning kernels' host side (#8 forward, #9 backward), on the
CPU: the batch groups that set their grids (each kernel its own), and the
input checks that guard their C entry points (each bad input raises
ValueError before any launch).
The kernels themselves run in tests/test_torch_cuda.py, on a card."""

import pytest
import torch

from mmd_tpu_torch.ops import swin_attention as SA

SMS = 132


@pytest.mark.parametrize("nw,b,heads,want", [
    (64, 8, 4, 2),        # Swinv2-base stage 0: 512 CTAs of 4 rows
    (16, 8, 8, 4),        # stage 1
    (4, 8, 16, 8),        # stage 2: 512 CTAs of 1 row
    (1, 8, 32, 8),        # stage 3: 256 CTAs, fewer than 264
    (64, 1, 4, 1),        # B 1
    (16, 7, 8, 7),        # B 7 (prime): 1 group gives only 128 CTAs
    (64, 7, 4, 7),
    (1, 7, 32, 7),        # nW 1
    (1, 1, 32, 1),
    (300, 8, 1, 1),       # one group already fills the card
])
def test_batch_groups_divide_the_batch_and_fill_the_card(nw, b, heads, want):
    g = SA.batch_groups(nw, b, heads, 64)
    assert g == want
    assert b % g == 0
    if nw * heads * b >= 2 * SMS:
        assert nw * heads * g >= 2 * SMS
        # the fewest such groups: no smaller divisor reaches 264 CTAs
        assert all(nw * heads * d < 2 * SMS
                   for d in range(1, g) if b % d == 0)
    else:
        assert g == b                     # one row a CTA


@pytest.mark.parametrize("nw,b,heads,want", [
    (64, 8, 4, 1),        # Swinv2-base stage 0: 256 CTAs of 8 rows, one launch
    (16, 8, 8, 2),        # stage 1: 128 pairs, short of one CTA an SM
    (4, 8, 16, 4),        # stage 2: 256 CTAs of 2 rows
    (1, 8, 32, 8),        # stage 3: 256 CTAs of 1 row
    (64, 7, 4, 1),        # B 7 (prime)
    (16, 7, 4, 7),
    (1, 1, 32, 1),        # B 1
    (300, 8, 1, 1),
])
def test_bwd_batch_groups_fill_the_card_once(nw, b, heads, want):
    """The backward's own split: one CTA an SM (132), not the forward's
    two, so that a (window, head) keeps its batch rows in one CTA, and
    dbias its one launch, wherever that fills the card."""
    g = SA.bwd_batch_groups(nw, b, heads, 64)
    assert g == want
    assert b % g == 0
    if nw * heads * b >= SMS:
        assert nw * heads * g >= SMS
        assert all(nw * heads * d < SMS for d in range(1, g) if b % d == 0)
    else:
        assert g == b


@pytest.mark.parametrize("nw,b,heads,n,want", [
    (16, 16, 4, 256, 2),   # window 16, stage 0, a served batch: 512 CTAs
    (4, 16, 8, 256, 4),    # stage 1
    (1, 16, 16, 256, 8),   # stage 2: 64 tile pairs, 512 CTAs of 2 rows
    (16, 8, 4, 576, 1),    # window 24, stage 0: 576 CTAs at one group
    (1, 8, 16, 576, 2),
    (1, 3, 4, 1024, 3),    # a 32 x 32 window: 64 tiles, one row a CTA
])
def test_batch_groups_count_the_query_tiles(nw, b, heads, n, want):
    """Above 64 tokens the forwards' CTAs are (query tile, head, window,
    group): n / 64 tiles a window count toward the 264 CTAs."""
    tiles = n // 64
    g = SA.batch_groups(nw, b, heads, n)
    assert g == want and b % g == 0
    if nw * heads * tiles * b >= 2 * SMS:
        assert nw * heads * tiles * g >= 2 * SMS
        assert all(nw * heads * tiles * d < 2 * SMS
                   for d in range(1, g) if b % d == 0)
    else:
        assert g == b


@pytest.mark.parametrize("nw,b,heads,n,want,floats", [
    # window 16, stage 0 at batch 8: 256 CTAs, one group, statistics only
    (16, 8, 4, 256, 1, 3 * 16 * 8 * 4 * 256),
    # stage 1: 128 CTAs at one group, so two, each a dbias part
    (4, 8, 8, 256, 2, 2 * 4 * 8 * 256 ** 2 + 3 * 4 * 8 * 8 * 256),
    (1, 8, 16, 256, 4, 4 * 16 * 256 ** 2 + 3 * 8 * 16 * 256),
    (1, 8, 16, 576, 1, 3 * 8 * 16 * 576),
    (64, 8, 4, 64, 1, 0),  # 64 tokens: no workspace at one group
    (16, 8, 8, 64, 2, 2 * 16 * 8 * 64 ** 2),
])
def test_bwd_batch_groups_and_workspace_at_large_windows(nw, b, heads, n,
                                                         want, floats):
    """The backward's groups count the tiles too (one CTA an SM), and its
    workspace holds the groups' dbias parts and, above 64 tokens, the query
    side's row statistics (m, 1 / l, D) for the key side."""
    g = SA.bwd_batch_groups(nw, b, heads, n)
    assert g == want and b % g == 0
    assert SA.bwd_workspace_floats(nw, b, heads, n, g) == floats


def _good(nw=4, b=2, c=128, heads=4, dtype=torch.bfloat16, n=64):
    q, k, v, do = (torch.zeros(nw, b, n, c, dtype=dtype) for _ in range(4))
    bias = torch.zeros(nw, heads, n, n)
    return dict(q=q, k=k, v=v, bias=bias, heads=heads, do=do)


def _bad_inputs():
    x = _good()
    yield "q not 4-d", dict(x, q=x["q"][0])
    yield "k of another shape", dict(x, k=torch.zeros(4, 3, 64, 128,
                                                      dtype=torch.bfloat16))
    y = _good()
    y["q"], y["k"], y["v"] = (t[:, :, :32].contiguous()
                              for t in (y["q"], y["k"], y["v"]))
    yield "32-token windows", dict(y, do=None)
    z = _good(n=144)
    yield "144-token windows", z
    z = _good(n=256)
    yield "256 tokens, bias for 64", dict(z, bias=torch.zeros(4, 4, 64, 64))
    yield "C not a multiple of heads", dict(x, heads=3)
    yield "head dim 16", dict(x, heads=8, bias=torch.zeros(4, 8, 64, 64))
    yield "head dim 128", _good(c=256, heads=2)
    yield "float16", _good(dtype=torch.float16)
    yield "k in another dtype", dict(x, k=x["k"].float())
    yield "v in another dtype", dict(x, v=x["v"].float())
    yield "do in another dtype", dict(x, do=x["do"].float())
    yield "do of another shape", dict(x, do=x["do"][:, :1].contiguous())
    yield "bias bf16", dict(x, bias=x["bias"].to(torch.bfloat16))
    yield "bias for one window", dict(x, bias=x["bias"][:1].contiguous())
    yield "bias for other heads", dict(x, bias=torch.zeros(4, 2, 64, 64))
    yield "q not contiguous", dict(x, q=torch.zeros(
        4, 2, 128, 64, dtype=torch.bfloat16).transpose(2, 3))
    yield "bias not contiguous", dict(x, bias=torch.zeros(
        4, 4, 64, 64).transpose(2, 3))
    yield "do not contiguous", dict(x, do=torch.zeros(
        4, 2, 128, 64, dtype=torch.bfloat16).transpose(2, 3))
    yield "k on another device", dict(x, k=x["k"].to("meta"))
    yield "bias on another device", dict(x, bias=x["bias"].to("meta"))
    yield "do on another device", dict(x, do=x["do"].to("meta"))


@pytest.mark.parametrize("what,args", list(_bad_inputs()),
                         ids=[w for w, _ in _bad_inputs()])
def test_train_checks_refuse_what_the_kernels_do_not_take(what, args):
    with pytest.raises(ValueError):
        SA._check_train_inputs(**args)
    if args["do"] is not None and what.startswith("do "):
        return                    # the forward has no do to refuse
    if args["do"] is not None:
        with pytest.raises(ValueError):
            SA._check_train_inputs(**dict(args, do=None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads", [(128, 4), (128, 2)])
def test_train_checks_pass_what_the_kernels_take(dtype, c, heads):
    args = _good(c=c, heads=heads, dtype=dtype)
    SA._check_train_inputs(**args)
    SA._check_train_inputs(**dict(args, do=None))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads,n", [(128, 4, 256), (128, 2, 256),
                                       (128, 4, 576), (64, 2, 1024)])
def test_train_checks_pass_windows_past_8x8(dtype, c, heads, n):
    """16 x 16, 24 x 24 and 32 x 32 windows: the blocked kernels'."""
    args = _good(nw=1, c=c, heads=heads, dtype=dtype, n=n)
    SA._check_train_inputs(**args)
    SA._check_train_inputs(**dict(args, do=None))
