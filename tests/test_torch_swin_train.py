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
    g = SA.batch_groups(nw, b, heads)
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
    g = SA.bwd_batch_groups(nw, b, heads)
    assert g == want
    assert b % g == 0
    if nw * heads * b >= SMS:
        assert nw * heads * g >= SMS
        assert all(nw * heads * d < SMS for d in range(1, g) if b % d == 0)
    else:
        assert g == b


def _good(nw=4, b=2, c=128, heads=4, dtype=torch.bfloat16):
    q, k, v, do = (torch.zeros(nw, b, 64, c, dtype=dtype) for _ in range(4))
    bias = torch.zeros(nw, heads, 64, 64)
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
