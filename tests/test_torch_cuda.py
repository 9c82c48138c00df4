"""Port tests that need an NVIDIA GPU (marker `cuda`); they skip without one.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, where tests/conftest.py (which imports JAX) cannot load:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It holds each hand-written kernel against its plain PyTorch version at the
serving paths' geometries -- flash attention, (residual +) LayerNorm (at
every C / 128 build, ragged tiles, twice bit for bit, on a side stream),
Swinv2 window attention and DeBERTa disentangled attention, flash
attention at the captioner's geometries (a decode step's query of 1 row
against 64 and 577 keys, a caption against 64, BLIP's 577-token ViT; #2
at the caption's) and a small captioner on the card against the CPU --
and the
small serving paths on the card against the same paths on the CPU (one
of them served from converted assets and a best_model.pt); and
the training kernels -- dropout (bit for bit), flash attention with
dropout and its backward, the fused GELU-MLP forward and backward and their
mask oracle -- and small fp32 and bf16 train steps on the card against the
same steps on the CPU; and the fine-tuning kernels -- the DeBERTa attention
backward and the Swin window attention's fine-tuning forward and backward,
dbias included, and the DeBERTa forward at the fine-tuning geometry and
twice bit for bit -- with the autograd graph kept through every trainable
wrapper and the fused-MLP routing limited to the kernels' widths; the
fused MLP backward twice bit for bit at the train step's geometries, and
its forward twice bit for bit at a partial row tile and at the text call's
row count; the fusion step's wider widths (--embed_dim 384 and 512 over 4
heads): flash attention at head dims 96 and 112 at the step's geometries
and the fused MLP at D 384 / F 1536 and D 512 / F 2048, and the step's
kernel launches; and
attention geometries the kernels do not take (flash dh 256, DeBERTa dh
128) routed to the explicit path, whose results they give; Swin windows of
16 x 16, 24 x 24 and 32 x 32 (256, 576, 1024 tokens) through #7, #8 and #9
over key blocks, and a window-16 Swinv2 on them against its explicit path; and the fused pipeline's bank resize against the CPU and its
ingest (pinned, double-buffered staging) against the raw store.
Tolerances: fp32 within 1e-4 (summation order, exp2f); bf16 within one
bf16 step at the largest |output| (the output is rounded to bf16 once);
gradients relative to their largest |value| (1e-4 in fp32); the fused MLP
within 2^-7 of each output's largest |value| (one bf16 rounding of the
output and of h, dyb and dab inside).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmd_tpu_torch.ops import attention as A
from mmd_tpu_torch.ops import deberta_attention as DA
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops import ln as LN
from mmd_tpu_torch.ops import mlp as M
from mmd_tpu_torch.ops import swin_attention as SA

pytestmark = pytest.mark.cuda

B = 4
# (T, S, D, H, masked): text, ViT, fusion self and cross, ragged (S not a
# multiple of the kernels' 64-key tile) at dh 64 and dh 32
GEOMETRIES = [(512, 512, 384, 6, True), (64, 64, 1024, 16, False),
              (512, 64, 256, 8, False), (64, 512, 256, 8, False),
              (100, 130, 128, 2, True), (77, 50, 64, 2, False),
              # head dim 128: FakeNet's (512 text, 64 image tokens, D 256,
              # 2 heads) and a ragged, padded one
              (512, 64, 256, 2, False), (64, 512, 256, 2, False),
              (100, 130, 512, 4, True),
              # head dims 96 (the fusion CLI's --embed_dim 384
              # --num_heads 4), 48 and 112, one ragged and padded
              (512, 64, 384, 4, False), (64, 512, 384, 4, False),
              (100, 130, 192, 4, True), (77, 50, 448, 4, False)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, t, s, d, masked, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, d, device=dev, generator=g)
               for n in (t, s, s))
    mask = None
    if masked:
        lengths = torch.tensor([s, s // 2 + 1, 1, 0], device=dev)
        mask = (torch.arange(s, device=dev)[None] < lengths[:, None]).int()
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d,h,masked", GEOMETRIES)
def test_kernel_matches_plain(cuda_device, dtype, t, s, d, h, masked):
    q, k, v, mask = _inputs(cuda_device, t, s, d, masked)
    before = A.launches
    o, lse = A.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), h,
                               mask)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    o_p, lse_p = A.flash_attention_plain(q.to(dtype).float(),
                                         k.to(dtype).float(),
                                         v.to(dtype).float(), h, mask)
    assert o.dtype == dtype and o.shape == q.shape
    assert (o.float() - o_p).abs().max().item() < TOL[dtype]
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_p[fin]).abs().max().item() < 1e-3
    if masked:                             # the row with no valid key
        assert torch.all(o[-1] == 0) and torch.all(torch.isneginf(lse[-1]))


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v, _ = _inputs(cuda_device, 16, 16, 64, False)
    with pytest.raises(ValueError, match="head dims"):
        A.flash_attention(q, k, v, 4)             # dh = 16
    with pytest.raises(ValueError, match="dtype"):
        A.flash_attention(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention(q.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v, 2)


def test_small_serving_path_matches_cpu(cuda_device, tmp_path):
    """The same small predictor (head dim 32, fused attention, fp32) on the
    card and on the CPU: identical labels and None-paths, probabilities
    within 1e-4; the card's run goes through the kernel."""
    import copy
    import dataclasses

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models import frozen, text_encoder, vit

    text_cfg = dataclasses.replace(text_encoder.TINY_TEST, hidden_size=64,
                                   num_heads=2, intermediate_size=128)
    vit_cfg = dataclasses.replace(vit.VIT_TEST, hidden_size=64, num_heads=2,
                                  intermediate_size=128)
    base = frozen.load_or_init_frozen(
        tmp_path, vocab_texts=["a claim about the river", "some evidence"],
        vocab_size=200, tiny=True)
    cfg = ModelConfig(text_input_dim=64, image_input_dim=64, embed_dim=64,
                      num_heads=2, hidden_dim=16, compute_dtype="float32",
                      fused_attn=True)
    text_cfg = dataclasses.replace(text_cfg,
                                   vocab_size=base.text_cfg.vocab_size)
    gen = torch.Generator().manual_seed(5)
    enc = frozen.FrozenEncoders(
        base.tokenizer, text_cfg, text_encoder.init_text_encoder(gen, text_cfg),
        vit_cfg, vit.init_vit(gen, vit_cfg))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (5, 32, 32, 3), dtype=np.uint8)
    ok = np.array([True, False, True, True, False])
    texts = [f"claim {i} about the river" for i in range(5)]
    out = {}
    for name in ("cpu", "cuda"):
        pred = MisinformationPredictor(cfg, encoders=copy.deepcopy(enc),
                                       batch_size=4, max_length=32,
                                       device=name)
        before = A.launches
        out[name] = pred.evaluate_arrays(texts, u8, ok, texts[::-1], u8,
                                         ok[::-1], detailed=True)
        if name == "cuda":
            # 2 text + 2 image batches x 2 layers each, 8 fusion attentions
            assert A.launches - before == 2 * 2 * 2 * 2 + 8
    for c, g in zip(out["cpu"], out["cuda"]):
        for path in c:
            assert (c[path] is None) == (g[path] is None)
            if c[path] is not None:
                assert g[path]["label"] == c[path]["label"]
                for lab, p in c[path]["probabilities"].items():
                    assert g[path]["probabilities"][lab] == pytest.approx(
                        p, abs=1e-4)


def _bf16_step(ref: torch.Tensor) -> float:
    """One bf16 step at the largest |ref|: the bound on one rounding."""
    top = ref.abs().max().item()
    return 2.0 ** (int(np.floor(np.log2(max(top, 1e-30)))) - 7)


def _tol(dtype, ref):
    return 1e-4 if dtype == torch.float32 else _bf16_step(ref)


def _ln_inputs(dev, dtype, rows, c, residual, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    ln = torch.nn.LayerNorm(c).to(dev)
    with torch.no_grad():
        ln.weight.normal_(generator=g)
        ln.bias.normal_(generator=g)
    y = torch.randn(rows, c, device=dev, generator=g).to(dtype)
    x = (torch.randn(rows, c, device=dev, generator=g).to(dtype)
         if residual else None)
    return ln, y, x


def _ln_plain(ln, y, x):
    return LN.fused_layernorm_plain(ln, y.float(), 1e-5,
                                    None if x is None else x.float())


# through the routing rule: the first four; then stage 2's width at 500
# tiles, fewer tiles than a block has warps (8 x 256; 40 x 128 in bf16), a
# grid stride of several turns (65536 x 128: 8192 bf16 tiles), and C 640,
# 768 and 896, so that every C / 128 build of the kernel launches. The rule
# passes only rows % 8 == 0, and every build's tile is 1, 2, 4 or 8 rows,
# so none of these has a ragged last tile:
# test_layernorm_kernel_takes_any_row_count calls the kernel directly for
# those.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,residual", [
    (4096, 128, False), (2048, 256, True), (512, 1024, True), (24, 384, True),
    (1000, 512, True), (8, 256, True), (65536, 128, True), (40, 128, True),
    (296, 640, True), (776, 768, False), (136, 896, False)])
def test_layernorm_kernel_matches_plain(cuda_device, dtype, rows, c,
                                        residual):
    ln, y, x = _ln_inputs(cuda_device, dtype, rows, c, residual)
    before = LN.launches
    with torch.no_grad():
        out = LN.fused_layernorm(ln, y, 1e-5, x)
        torch.cuda.synchronize()
        ref = _ln_plain(ln, y, x)
    assert LN.launches == before + 1 and out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= _tol(dtype, ref)


# rows (a tile: bf16 / fp32) -> the last tile's rows
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,residual", [
    (37, 128, True),        # tile 8 / 4: 5 / 1, five / ten tiles
    (5, 128, False),        # tile 8 / 4: below a tile / 1
    (3, 128, True),         # below a tile in both
    (5, 256, True),         # tile 4 / 2: 1 / 1
    (3, 1024, False),       # tile 1: three warps of a block busy
    (1, 384, True),         # tile 2 / 1: one row of a warp's two (bf16)
    (4095, 512, True),      # tile 2 / 1: 1 / whole, at stage 2's width
    (65535, 128, True)])    # tile 8 / 4: 7 / 3, after a grid stride's turns
def test_layernorm_kernel_takes_any_row_count(cuda_device, dtype, rows, c,
                                              residual):
    """A ragged last tile and fewer rows than a tile, which the routing rule
    never sends: the bulk copies and their expected bytes count only the
    rows there are (a count too high never completes the stage's phase)."""
    ln, y, x = _ln_inputs(cuda_device, dtype, rows, c, residual, seed=3)
    before = LN.launches
    with torch.no_grad():
        out = LN._layernorm_cuda(ln.weight, ln.bias, y, 1e-5, x)
        torch.cuda.synchronize()
        ref = _ln_plain(ln, y, x)
    assert LN.launches == before + 1 and out.shape == (rows, c)
    assert (out.float() - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,residual", [
    (65536, 128, True), (4096, 512, True), (1024, 1024, False)])
def test_layernorm_kernel_is_deterministic(cuda_device, dtype, rows, c,
                                           residual):
    """Two calls give the same bits (fixed-order sums, no atomics)."""
    ln, y, x = _ln_inputs(cuda_device, dtype, rows, c, residual, seed=2)
    with torch.no_grad():
        first = LN.fused_layernorm(ln, y, 1e-5, x)
        second = LN.fused_layernorm(ln, y, 1e-5, x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_layernorm_kernel_runs_on_the_current_stream(cuda_device):
    """The wrapper passes the current stream's raw handle: on a side stream
    that first sleeps, the output is right once that stream is done."""
    ln, y, x = _ln_inputs(cuda_device, torch.bfloat16, 4096, 512, True)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.no_grad(), torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000)
        out = LN.fused_layernorm(ln, y, 1e-5, x)
    side.synchronize()
    ref = _ln_plain(ln, y, x)
    assert (out.float() - ref).abs().max().item() <= _tol(torch.bfloat16,
                                                          ref)


def test_layernorm_refuses_what_it_does_not_take(cuda_device):
    ln, y, x = _ln_inputs(cuda_device, torch.bfloat16, 64, 256, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        LN._layernorm_cuda(ln.weight, ln.bias, y.half(), 1e-5, None)
    with pytest.raises(ValueError, match="contiguous y"):
        LN._layernorm_cuda(ln.weight, ln.bias, torch.cat([y, y], 1)[:, :256],
                           1e-5, None)
    with pytest.raises(ValueError, match="shortcut"):
        LN._layernorm_cuda(ln.weight, ln.bias, y, 1e-5, x.float())
    with pytest.raises(ValueError, match="scale and bias"):
        LN._layernorm_cuda(ln.weight[:128], ln.bias[:128], y, 1e-5, None)
    skewed = torch.empty(64 * 256 + 4, dtype=torch.bfloat16,
                         device=cuda_device)[4:].view(64, 256)
    with pytest.raises(ValueError, match="16-byte aligned"):
        LN._layernorm_cuda(ln.weight, ln.bias, skewed, 1e-5, None)


# the Swinv2-base window attentions of a served batch of 16: (nW, C,
# heads, bias windows), unshifted blocks sharing one bias tile; and head
# dim 64
SWIN_SERVED = [(64, 128, 4, 1), (64, 128, 4, 64), (16, 256, 8, 1),
               (16, 256, 8, 16), (4, 512, 16, 1), (4, 512, 16, 4),
               (1, 1024, 32, 1), (4, 256, 4, 4)]


def _swin_serving_inputs(dev, dtype, nw, b, c, heads, nwb, seed, n=64):
    """Raw q, k, v; the position bias in (0, 16) plus, for shifted blocks,
    twice a 0 / -100 region mask; logit scales up to the clamp of 100."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(nw, b, n, c, device=dev, generator=g).to(dtype)
               for _ in range(3))
    bias = 16 * torch.rand(1, heads, n, n, device=dev, generator=g)
    if nwb > 1:
        bias = bias - 200.0 * (torch.rand(nwb, 1, n, n, device=dev,
                                          generator=g) < 0.3)
    bias = bias.expand(nwb, heads, n, n).contiguous()
    scale = torch.exp(torch.clamp(
        torch.rand(heads, device=dev, generator=g) * 5, max=np.log(100.0)))
    return q, k, v, bias, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw,c,heads,nwb", SWIN_SERVED)
def test_swin_kernel_matches_plain(cuda_device, dtype, nw, c, heads, nwb):
    q, k, v, bias, scale = _swin_serving_inputs(cuda_device, dtype, nw, 16,
                                                c, heads, nwb, seed=2)
    before = SA.launches
    o = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    torch.cuda.synchronize()
    ref = SA.swin_window_attention_infer_plain(q.float(), k.float(),
                                               v.float(), bias, scale, heads)
    assert SA.launches == before + 1 and o.dtype == dtype
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw,b,c,heads,nwb", [
    (4, 5, 512, 16, 4), (16, 12, 256, 8, 1), (4, 12, 256, 4, 4)])
def test_swin_kernel_uneven_batch_zero_rows_scale_100(cuda_device, dtype, nw,
                                                      b, c, heads, nwb):
    """Batches that `batch_groups` splits unevenly against its CTA target
    (B 5: one row a group; B 12), a zero q row and a zero k row (the 1e-12
    floor), every logit scale at the clamp of 100; two calls give the same
    bits."""
    q, k, v, bias, scale = _swin_serving_inputs(cuda_device, dtype, nw, b,
                                                c, heads, nwb, seed=5)
    dh = c // heads
    q[0, 0, 5, :dh] = 0
    k[nw - 1, b - 1, 7, c - dh:] = 0
    scale = torch.full_like(scale, 100.0)
    before = SA.launches
    o = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    again = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    torch.cuda.synchronize()
    assert SA.launches == before + 2
    assert torch.equal(o, again)
    ref = SA.swin_window_attention_infer_plain(q.float(), k.float(),
                                               v.float(), bias, scale, heads)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)


# Windows past 8 x 8, (n, nW, B, C, heads, bias windows): Swinv2-base's
# stages at window 16 (16, 4 and 1 windows of 256 tokens, shifted and not),
# at window 24 (576), one 32 x 32 window stage (1024); head dim 64; B 3 and
# 5, which `batch_groups` splits one row a group
SWIN_BLOCKED = [(256, 16, 4, 128, 4, 16), (256, 4, 4, 256, 8, 1),
                (256, 1, 5, 512, 16, 1), (256, 4, 3, 256, 4, 4),
                (576, 16, 2, 128, 4, 1), (576, 4, 2, 256, 8, 4),
                (576, 1, 3, 512, 16, 1), (1024, 4, 2, 128, 4, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nw,b,c,heads,nwb", SWIN_BLOCKED)
def test_swin_kernel_at_large_windows_matches_plain(cuda_device, dtype, n,
                                                    nw, b, c, heads, nwb):
    """#7 over key blocks of 64 (the blocked body): a zero q row and a zero
    k row, logit scales up to the clamp; two calls give the same bits."""
    q, k, v, bias, scale = _swin_serving_inputs(cuda_device, dtype, nw, b,
                                                c, heads, nwb, seed=7, n=n)
    dh = c // heads
    q[0, 0, 5, :dh] = 0
    k[nw - 1, b - 1, n - 7, c - dh:] = 0
    before = SA.launches
    o = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    again = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    torch.cuda.synchronize()
    assert SA.launches == before + 2 and o.dtype == dtype
    assert torch.equal(o, again)
    ref = SA.swin_window_attention_infer_plain(q.float(), k.float(),
                                               v.float(), bias, scale, heads)
    assert torch.isfinite(o.float()).all()
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,heads", [(512, 384, 6), (128, 128, 4),
                                       (64, 64, 2),
                                       # a rank's heads under TP 2
                                       (512, 192, 3)])
def test_deberta_kernel_matches_plain(cuda_device, dtype, t, d, heads):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(B, t, d, device=cuda_device, generator=g)
               .to(dtype) for _ in range(3))
    pk, pq = (torch.randn(2 * t, d, device=cuda_device, generator=g)
              .to(dtype) for _ in range(2))
    lengths = torch.tensor([t, t // 2 + 1, 1, 0], device=cuda_device)
    mask = (torch.arange(t, device=cuda_device)[None]
            < lengths[:, None]).int()
    scale = 1.0 / np.sqrt(3.0 * d // heads)
    before = DA.launches
    o = DA.deberta_attention(q, k, v, pk, pq, mask, heads, scale)
    torch.cuda.synchronize()
    ref = DA.deberta_attention_plain(q.float(), k.float(), v.float(),
                                     pk.float(), pq.float(), mask, heads,
                                     scale)
    assert DA.launches == before + 1 and o.dtype == dtype
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)
    # the row with no valid key is the uniform mean of V
    uniform = v[-1].float().mean(0).expand(t, d)
    assert (o[-1].float() - uniform).abs().max().item() <= _tol(dtype, ref)


def test_new_kernels_refuse_what_they_do_not_take(cuda_device):
    ln = torch.nn.LayerNorm(2048).to(cuda_device)
    y = torch.zeros(8, 2048, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 128"):
        LN._layernorm_cuda(ln.weight, ln.bias, y, 1e-5, None)
    # the routing rule (fused_ln_ok) keeps such a width off the kernel
    before = LN.launches
    LN.fused_layernorm(ln, y)
    assert LN.launches == before
    q = torch.zeros(1, 1, 16, 128, device=cuda_device)
    with pytest.raises(ValueError, match="64 tokens"):
        SA.swin_window_attention_infer(
            q, q, q, torch.zeros(1, 4, 16, 16, device=cuda_device),
            torch.ones(4, device=cuda_device), 4)
    q = torch.zeros(1, 96, 128, device=cuda_device)
    tab = torch.zeros(192, 128, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 64"):
        DA.deberta_attention(q, q, q, tab, tab, None, 2, 0.1)


def test_small_reference_serving_path_matches_cpu(cuda_device, tmp_path):
    """DeBERTa-v3 + Swinv2 at widths that take every kernel (fp32): the
    card's run matches the CPU's and goes through each kernel."""
    import copy

    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models import deberta, frozen, swin

    base = frozen.load_or_init_frozen(
        tmp_path, vocab_texts=["a claim about the river", "some evidence"],
        vocab_size=200, tiny=True)
    text_cfg = deberta.DebertaConfig(
        vocab_size=base.text_cfg.vocab_size, hidden_size=128, num_layers=2,
        num_heads=2, intermediate_size=256, max_position=64,
        position_buckets=16)
    img_cfg = swin.SwinConfig(image_size=64, patch_size=4, embed_dim=128,
                              depths=(2, 2), num_heads=(4, 8), window_size=8,
                              pretrained_window_sizes=(0, 0),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(5)
    enc = frozen.FrozenEncoders(
        base.tokenizer, text_cfg, deberta.init_deberta(gen, text_cfg),
        img_cfg, swin.init_swin(gen, img_cfg))
    cfg = ModelConfig(text_input_dim=128, image_input_dim=256,
                      compute_dtype="float32", fused_attn=True)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    ok = np.array([True, False, True, True])
    texts = [f"claim {i} about the river" for i in range(4)]
    out = {}
    for name in ("cpu", "cuda"):
        pred = MisinformationPredictor(cfg, encoders=copy.deepcopy(enc),
                                       batch_size=4, max_length=64,
                                       device=name)
        counts = (DA.launches, SA.launches, LN.launches, A.launches)
        out[name] = pred.evaluate_arrays(texts, u8, ok, texts[::-1], u8,
                                         ok[::-1], detailed=True)
        if name == "cuda":
            got = [now - was for now, was in zip(
                (DA.launches, SA.launches, LN.launches, A.launches), counts)]
            # per encode: 2 DeBERTa layers; 4 Swin blocks; 1 + 8 + 1 + 1
            # LayerNorms; 8 fusion attentions per batch
            assert got == [2 * 2, 2 * 4, 2 * 11, 8]
    for c, g in zip(out["cpu"], out["cuda"]):
        for path in c:
            assert (c[path] is None) == (g[path] is None)
            if c[path] is not None:
                assert g[path]["label"] == c[path]["label"]
                for lab, p in c[path]["probabilities"].items():
                    assert g[path]["probabilities"][lab] == pytest.approx(
                        p, abs=1e-4)


def test_converted_assets_serving_path_matches_cpu(cuda_device, tmp_path):
    """A trained model served from files -- DeBERTa-v3 and Swinv2 assets
    with sidecars, an spm.json and a fusion best_model.pt, written as
    mmd_tpu_torch/convert_hf.py and the trainer write them -- at widths
    that take every kernel (fp32): the card's run matches the CPU's and
    goes through each kernel."""
    from mmd_tpu_torch.convert_hf import write_asset
    from mmd_tpu_torch.core.checkpoint import save_params
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.data.spm import (
        CONTROL, METASPACE, NORMAL, UNKNOWN, UnigramTokenizer,
    )
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.models import deberta, swin
    from mmd_tpu_torch.models.fusion import init_fusion_params

    texts = [f"claim {i} about the river rising again" for i in range(4)]
    words = sorted({w for t in texts for w in t.split()})
    chars = sorted({c for t in texts for c in t if c != " "})
    pieces = [("[PAD]", 0.0, CONTROL), ("[CLS]", 0.0, CONTROL),
              ("[SEP]", 0.0, CONTROL), ("[UNK]", 0.0, UNKNOWN)]
    rng = np.random.default_rng(0)
    for tok in [METASPACE] + chars + [METASPACE + w for w in words]:
        pieces.append((tok, float(-1.0 - 12.0 * rng.random()), NORMAL))
    UnigramTokenizer(pieces).save(tmp_path / "spm.json")
    text_cfg = deberta.DebertaConfig(
        vocab_size=128, hidden_size=128, num_layers=2, num_heads=2,
        intermediate_size=256, max_position=64, position_buckets=16)
    img_cfg = swin.SwinConfig(image_size=64, patch_size=4, embed_dim=128,
                              depths=(2, 2), num_heads=(4, 8), window_size=8,
                              pretrained_window_sizes=(0, 0),
                              compute_dtype="float32")
    gen = torch.Generator().manual_seed(5)
    write_asset(tmp_path, "deberta", deberta.init_deberta(gen, text_cfg),
                text_cfg)
    write_asset(tmp_path, "swinv2", swin.init_swin(gen, img_cfg), img_cfg)
    cfg = ModelConfig(text_input_dim=128, image_input_dim=256,
                      compute_dtype="float32", fused_attn=True)
    save_params(str(tmp_path / "best_model.pt"),
                init_fusion_params(torch.Generator().manual_seed(7), cfg))
    u8 = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    ok = np.array([True, False, True, True])
    out = {}
    for name in ("cpu", "cuda"):
        pred = MisinformationPredictor(
            cfg, checkpoint_path=str(tmp_path / "best_model.pt"),
            assets_dir=str(tmp_path), batch_size=4, max_length=64,
            device=name)
        counts = (DA.launches, SA.launches, LN.launches, A.launches)
        out[name] = pred.evaluate_arrays(texts, u8, ok, texts[::-1], u8,
                                         ok[::-1], detailed=True)
        if name == "cuda":
            got = [now - was for now, was in zip(
                (DA.launches, SA.launches, LN.launches, A.launches), counts)]
            assert got == [2 * 2, 2 * 4, 2 * 11, 8]
    for c, g in zip(out["cpu"], out["cuda"]):
        for path in c:
            assert (c[path] is None) == (g[path] is None)
            if c[path] is not None:
                assert g[path]["label"] == c[path]["label"]
                for lab, p in c[path]["probabilities"].items():
                    assert g[path]["probabilities"][lab] == pytest.approx(
                        p, abs=1e-4)


# -- training kernels -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 1024), (1024, 256), (256, 64),
                                   (37, 257), (3,)])
def test_dropout_kernel_is_bit_identical_to_plain(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
    before = D.launches
    y = D.dropout(x, 0.1, 0xC0FFEE)
    torch.cuda.synchronize()
    assert D.launches == before + 1
    want = D.dropout_plain(x, 0.1, 0xC0FFEE)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert y.dtype == dtype and torch.equal(y.view(bits), want.view(bits))


def test_dropout_kernel_backward_regenerates_the_mask(cuda_device):
    x = torch.randn(300, 130, device=cuda_device, requires_grad=True)
    gout = torch.randn(300, 130, device=cuda_device)
    before = D.launches
    D.dropout(x, 0.3, 5).backward(gout)
    torch.cuda.synchronize()
    assert D.launches == before + 2
    assert torch.equal(x.grad, gout * D.keep_scale(5, x.shape, 0.3,
                                                   cuda_device))


def _rel_err(got, ref):
    return (got.float() - ref).abs().max().item() / max(
        ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d,h,masked", GEOMETRIES)
def test_flash_dropout_matches_plain(cuda_device, dtype, t, s, d, h, masked):
    q, k, v, mask = _inputs(cuda_device, t, s, d, masked)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    o, lse = A.flash_attention(q, k, v, h, mask, 0.1, 1234)
    torch.cuda.synchronize()
    o_p, lse_p = A.flash_attention_plain(q.float(), k.float(), v.float(), h,
                                         mask, 0.1, 1234)
    assert (o.float() - o_p).abs().max().item() <= _tol(dtype, o_p)
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_p[fin]).abs().max().item() < 1e-3


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,s,d,h,masked", GEOMETRIES)
def test_flash_bwd_matches_plain(cuda_device, rate, dtype, t, s, d, h,
                                 masked):
    q, k, v, mask = _inputs(cuda_device, t, s, d, masked)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    o, lse = A.flash_attention(q, k, v, h, mask, rate, 99)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    before = A.bwd_launches
    got = A.flash_attention_bwd(q, k, v, o, lse, do, h, mask, rate, 99)
    torch.cuda.synchronize()
    assert A.bwd_launches == before + 1
    want = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), h, mask,
                                       rate, 99)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        tol = 1e-4 if dtype == torch.float32 else 2 ** -7
        assert _rel_err(g, w) <= tol
    if masked:                             # the row with no valid key
        assert torch.all(got[0][-1] == 0)


# the captioner's geometries (T, S, D, H, dtype): a decode step of the
# default captioner (bf16, 64 image tokens) and of BLIP-base (fp32, 577
# image tokens: a ragged last key tile of one key), a 32-token caption's
# cross-attention, and BLIP's ViT blocks
CAPTION_GEOMETRIES = [(1, 64, 384, 6, torch.bfloat16),
                      (1, 577, 768, 12, torch.float32),
                      (32, 64, 384, 6, torch.bfloat16),
                      (577, 577, 768, 12, torch.float32)]


@pytest.mark.parametrize("t,s,d,h,dtype", CAPTION_GEOMETRIES)
def test_flash_captioner_geometries_match_plain(cuda_device, t, s, d, h,
                                                dtype):
    q, k, v, _ = _inputs(cuda_device, t, s, d, False)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    before = A.launches
    o, lse = A.flash_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    o_p, lse_p = A.flash_attention_plain(q.float(), k.float(), v.float(), h)
    assert (o.float() - o_p).abs().max().item() <= _tol(dtype, o_p)
    assert (lse - lse_p).abs().max().item() < 1e-3


def test_flash_bwd_caption_geometry_matches_plain(cuda_device):
    """#2 at a 32-token caption's cross-attention over 64 image tokens,
    bf16 (the default captioner's training step)."""
    q, k, v, _ = _inputs(cuda_device, 32, 64, 384, False)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    o, lse = A.flash_attention(q, k, v, 6)
    do = torch.randn(q.shape, device=cuda_device).to(torch.bfloat16)
    before = A.bwd_launches
    got = A.flash_attention_bwd(q, k, v, o, lse, do, 6)
    torch.cuda.synchronize()
    assert A.bwd_launches == before + 1
    want = A.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                       o.float(), lse, do.float(), 6)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel_err(g, w) <= 2 ** -7


def test_small_captioner_on_the_card_matches_cpu(cuda_device):
    """A small fp32 captioner with head dim 64 (so the ViT and the
    cross-attention take #1): teacher-forced decode logits on the card
    within 1e-4 of the CPU's, relative to the largest |logit|; one #1
    launch a ViT block and a decode step's layer, none elsewhere."""
    from mmd_tpu_torch.models import captioner as C
    from mmd_tpu_torch.models import vit as V
    from mmd_tpu_torch.models.transformer import TransformerConfig
    cfg = C.CaptionerConfig(
        vit=dataclasses.replace(V.VIT_TEST, hidden_size=128, num_heads=2),
        decoder=TransformerConfig(
            vocab_size=96, hidden_size=128, num_layers=2, num_heads=2,
            intermediate_size=256, max_position=16, type_vocab_size=0,
            is_decoder=True, encoder_hidden_size=128,
            compute_dtype="float32"),
        max_caption_len=8)
    params = C.init_captioner(torch.Generator().manual_seed(3), cfg)
    images = torch.randn(3, 32, 32, 3, generator=torch.Generator()
                         .manual_seed(4))
    forced = torch.randint(4, 96, (3, 8),
                           generator=torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", "cuda"):
        p = params.to(dev)
        before = A.launches
        enc = V.vit_forward(p["vit"], cfg.vit, images.to(dev))
        out[dev] = C.decode(p, cfg, enc.detach(), 2, 3, 0,
                            forced=forced.to(dev))[1].cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert A.launches - before == 2 + 8 * 2
    scale = out["cpu"].abs().max().item()
    assert (out["cuda"] - out["cpu"]).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(cuda_device, rate, dtype):
    """Two backward calls on the same inputs give bit-identical dq, dk and
    dv: the kernels sum in a fixed order (two passes, no atomics)."""
    q, k, v, mask = _inputs(cuda_device, 100, 130, 128, True)
    q, k, v = (x.to(dtype) for x in (q, k, v))
    o, lse = A.flash_attention(q, k, v, 2, mask, rate, 5)
    do = torch.randn(q.shape, device=cuda_device).to(dtype)
    first = A.flash_attention_bwd(q, k, v, o, lse, do, 2, mask, rate, 5)
    second = A.flash_attention_bwd(q, k, v, o, lse, do, 2, mask, rate, 5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_refuses_what_it_does_not_take(cuda_device):
    q, k, v, _ = _inputs(cuda_device, 64, 64, 64, False)
    o, lse = A.flash_attention(q, k, v, 2)
    with pytest.raises(ValueError, match="lse"):
        A.flash_attention_bwd(q, k, v, o, lse[:, :1], o, 2)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_attention_bwd(q, k, v, o, lse,
                              o.transpose(0, 1).contiguous().transpose(0, 1),
                              2)


def _tiny_train_cfg(**kw):
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    model = ModelConfig(text_input_dim=64, image_input_dim=96, embed_dim=64,
                        num_heads=2, hidden_dim=16, compute_dtype="float32",
                        fused_attn=True, **kw)
    return TrainConfig(model=model, batch_size=8, lr=1e-3)


def test_bf16_dropout_trainer_builds_on_the_card(cuda_device):
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.training.trainer import Trainer
    tr = Trainer(TrainConfig(model=ModelConfig()), device="cuda")
    assert tr.cfg.model.compute_dtype == "bfloat16"
    assert all(p.is_cuda for p in tr.init().params.parameters())


def test_small_train_step_matches_cpu(cuda_device):
    """One fp32 step with dropout 0.1 at head dim 32 on the card and on the
    CPU, same init and seed: the same masks, so the loss within 1e-5 and
    every grad leaf within 1e-4 of its largest |value|; the card's step
    launches 8 / 8 / 32 of the flash forward, backward and dropout
    kernels."""
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = _tiny_train_cfg()
    batch = synthetic_preembed_batch(np.random.default_rng(0), 8, 128, 64,
                                     64, 96)
    out = {}
    for name in ("cpu", "cuda"):
        tr = Trainer(cfg, device=name)
        state = tr.init()
        counts = (A.launches, A.bwd_launches, D.launches)
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        if name == "cuda":
            torch.cuda.synchronize()
            got = [now - was for now, was in zip(
                (A.launches, A.bwd_launches, D.launches), counts)]
            assert got == [8, 8, 32]
        out[name] = (float(aux["loss"]),
                     {n: p.grad.detach().cpu()
                      for n, p in state.params.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for n, w in gc.items():
        assert (gg[n] - w).abs().max().item() <= 1e-4 * max(
            w.abs().max().item(), 1e-3 * max(
                x.abs().max().item() for x in gc.values())), n


MLP_TOL = 2.0 ** -7


def _mlp_inputs(dev, n, d, f, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g).bfloat16()
    w1 = (torch.randn(d, f, device=dev, generator=g) / d ** 0.5).bfloat16()
    b1 = 0.1 * torch.randn(f, device=dev, generator=g)
    w2 = (torch.randn(f, d, device=dev, generator=g) / f ** 0.5).bfloat16()
    b2 = 0.1 * torch.randn(d, device=dev, generator=g)
    dy = torch.randn(n, d, device=dev, generator=g).bfloat16()
    return x, w1, b1, w2, b2, dy


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,d,f", [(100, 128, 256), (64, 256, 128),
                                   (1000, 256, 1024), (1, 128, 128),
                                   (65, 256, 1024), (1088, 256, 1024)])
def test_mlp_kernels_match_plain(cuda_device, rate, n, d, f):
    """#12 bit for bit; #3 and #4 within MLP_TOL of each output's scale;
    65, 1000 and 1088 rows end in a partial row tile and row group of
    #4."""
    x, w1, b1, w2, b2, dy = _mlp_inputs(cuda_device, n, d, f)
    seeds = M.mask_seeds(rate, 0xBEEF)
    was = (M.launches, M.bwd_launches, M.mask_launches)
    m1, m2 = M.mlp_masks(n, d, f, seeds, rate, cuda_device)
    y = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
    got = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
    torch.cuda.synchronize()
    assert (M.launches, M.bwd_launches, M.mask_launches) == tuple(
        c + 1 for c in was)
    p1, p2 = M.mlp_masks_plain(n, d, f, seeds, rate, cuda_device)
    assert torch.equal(m1, p1) and torch.equal(m2, p2)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert _rel_err(y, M.fused_mlp_plain(x, w1, b1, w2, b2, seeds,
                                         rate)) <= MLP_TOL
    want = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, seeds, rate)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 4
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= MLP_TOL, name


def test_fused_mlp_autograd_runs_the_kernels(cuda_device):
    """layers.mlp in bf16 with dropout takes fused_mlp on the card: one
    forward and one backward kernel, and the same masks as the unfused
    path on the CPU."""
    from mmd_tpu_torch.models import layers as L
    params = L.mlp_init(torch.Generator().manual_seed(0), 128, 4.0)
    x = torch.randn(2, 50, 128)
    out = {}
    for dev in ("cpu", "cuda"):
        p = L.mlp_init(torch.Generator().manual_seed(0), 128, 4.0).to(dev)
        p.load_state_dict(params.state_dict())
        xd = x.clone().to(dev).requires_grad_()
        was = (M.launches, M.bwd_launches)
        y = L.mlp(p, xd, 0.1, 42, False, torch.bfloat16)
        y.float().square().sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (M.launches - was[0], M.bwd_launches - was[1]) == (1, 1)
        out[dev] = (y.detach().float().cpu(), xd.grad.cpu(),
                    p["fc1"].weight.grad.cpu())
    (yc, gc, wc), (yg, gg, wg) = out["cpu"], out["cuda"]
    assert torch.equal(yc == 0, yg == 0)      # the same output mask
    for a, b in ((yg, yc), (gg, gc), (wg, wc)):
        assert _rel_err(a, b) <= 4 * MLP_TOL


def test_mlp_kernels_refuse_what_they_do_not_take(cuda_device):
    x, w1, b1, w2, b2, dy = _mlp_inputs(cuda_device, 32, 128, 256)
    seeds = M.mask_seeds(0.1, 1)
    with pytest.raises(ValueError, match="bfloat16"):
        M.fused_mlp_fwd(x.float(), w1, b1, w2, b2, seeds, 0.1)
    with pytest.raises(ValueError, match="D and F multiples of 128"):
        M.fused_mlp_fwd(x[:, :64].contiguous(), w1[:64].contiguous(), b1,
                        w2[:, :64].contiguous(), b2[:64], seeds, 0.1)
    wide = _mlp_inputs(cuda_device, 8, 1152, 128)
    with pytest.raises(ValueError, match="D up to 1024"):
        M.fused_mlp_fwd(*wide[:5], seeds, 0.1)
    with pytest.raises(ValueError, match="multiple of 128"):
        M.fused_mlp_bwd(x, w1[:, :200].contiguous(), b1[:200],
                        w2[:200].contiguous(), dy, seeds, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        M.fused_mlp_fwd(x, w1.T.contiguous().T, b1, w2, b2, seeds, 0.1)
    with pytest.raises(ValueError, match="dy"):
        M.fused_mlp_bwd(x, w1, b1, w2, dy.float(), seeds, 0.1)


def test_small_bf16_train_step_matches_cpu(cuda_device):
    """One bf16 step with dropout 0.1 at embed 128 (the fused MLP's
    smallest width), head dim 32, on the card -- fused MLP kernels -- and
    on the CPU -- the unfused MLP -- same init and seed, so the same masks:
    loss within 2e-2 relative and every grad leaf within 1e-1 of its
    largest |value| (bf16 rounding at other points on the two paths: the
    kernels keep fc1's output in fp32). The card's step launches 6 / 6 of
    the MLP kernels, 8 / 8 of the flash kernels and 8 elementwise
    dropouts (the heads')."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(model=ModelConfig(
        text_input_dim=64, image_input_dim=96, embed_dim=128, num_heads=4,
        hidden_dim=16, fused_attn=True), batch_size=8, lr=1e-3)
    batch = synthetic_preembed_batch(np.random.default_rng(0), 8, 128, 64,
                                     64, 96)
    kernels = lambda: (M.launches, M.bwd_launches, A.launches,  # noqa: E731
                       A.bwd_launches, D.launches)
    out = {}
    for name in ("cpu", "cuda"):
        tr = Trainer(cfg, device=name)
        state = tr.init()
        counts = kernels()
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        if name == "cuda":
            torch.cuda.synchronize()
            got = [now - was for now, was in zip(kernels(), counts)]
            assert got == [6, 6, 8, 8, 8]
        out[name] = (float(aux["loss"]),
                     {n: p.grad.detach().cpu()
                      for n, p in state.params.named_parameters()})
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 2e-2 * abs(lc), (lg, lc)
    top = max(x.abs().max().item() for x in gc.values())
    for n, w in gc.items():
        gap = (gg[n] - w).abs().max().item()
        assert gap <= 1e-1 * max(w.abs().max().item(), 1e-2 * top), (n, gap)


# -- the fine-tuning kernels: #11 (DeBERTa attention backward), #8 and #9
# (Swin window attention forward and backward) --------------------------------

def _grad_tol(dtype, ref):
    """fp32: summation order, 1e-4 of the largest |value|; bf16: one
    rounding of the output."""
    top = ref.abs().max().item()
    return 1e-4 * top if dtype == torch.float32 else _bf16_step(ref)


def _deberta_bwd_inputs(dev, dtype, b, t, d, seed=4):
    """q, k, v, do, PK, PQ and a key mask whose rows hold T, T - 11 (a
    padded tail), 0 (no valid key), 1 and then T / 2 + 3 valid keys."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, t, d, device=dev, generator=g).to(dtype)
                   for _ in range(4))
    pk, pq = (torch.randn(2 * t, d, device=dev, generator=g).to(dtype)
              for _ in range(2))
    lengths = ([t, t - 11, 0, 1] + [t // 2 + 3] * b)[:b]
    mask = (torch.arange(t, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).int()
    return q, k, v, pk, pq, mask, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads", [
    (4, 256, 384, 6), (4, 128, 128, 4), (4, 64, 64, 2), (3, 256, 128, 4),
    (5, 128, 256, 4), (3, 64, 384, 6), (7, 192, 128, 2)])
def test_deberta_bwd_kernel_matches_plain(cuda_device, dtype, b, t, d,
                                          heads):
    """Head dims 64 and 32 at T 64 to 256, B 3 to 7 (no CTA groups batch
    rows: any B), with a padded tail and a row with no valid key."""
    q, k, v, pk, pq, mask, do = _deberta_bwd_inputs(cuda_device, dtype, b,
                                                    t, d)
    scale = 1.0 / np.sqrt(3.0 * d // heads)
    before = DA.bwd_launches
    got = DA.deberta_attention_bwd(q, k, v, pk, pq, mask, do, heads, scale)
    torch.cuda.synchronize()
    assert DA.bwd_launches == before + 1
    want = DA.deberta_attention_bwd_plain(
        *(x.float() for x in (q, k, v, pk, pq)), mask, do.float(), heads,
        scale)
    for name, a, w in zip(("dq", "dk", "dv", "dPK", "dPQ"), got, want):
        assert a.shape == w.shape, name
        assert a.dtype == (dtype if name[1] != "P" else torch.float32), name
        tol = _grad_tol(dtype if name[1] != "P" else torch.float32, w)
        err = (a.float() - w).abs().max().item()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deberta_bwd_is_deterministic(cuda_device, dtype):
    """Two backward calls on the same inputs give bit-identical dq, dk, dv,
    dPK and dPQ: fixed-order sums, no atomics."""
    q, k, v, pk, pq, mask, do = _deberta_bwd_inputs(cuda_device, dtype, 5,
                                                    256, 384)
    first = DA.deberta_attention_bwd(q, k, v, pk, pq, mask, do, 6, 0.1)
    second = DA.deberta_attention_bwd(q, k, v, pk, pq, mask, do, 6, 0.1)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,heads", [(8, 256, 384, 6), (3, 192, 128, 4)])
def test_deberta_fwd_kernel_matches_plain_at_more_geometries(
        cuda_device, dtype, b, t, d, heads):
    """The forward at the fine-tuning geometry (B 8, T 256) and at T 192
    (three key tiles, dh 32), with a padded tail and a row with no valid
    key: against the plain version, and that row against the uniform mean
    of V."""
    q, k, v, pk, pq, mask, _ = _deberta_bwd_inputs(cuda_device, dtype, b, t,
                                                   d)
    scale = 1.0 / np.sqrt(3.0 * d // heads)
    before = DA.launches
    o = DA.deberta_attention(q, k, v, pk, pq, mask, heads, scale)
    torch.cuda.synchronize()
    assert DA.launches == before + 1 and o.dtype == dtype
    ref = DA.deberta_attention_plain(q.float(), k.float(), v.float(),
                                     pk.float(), pq.float(), mask, heads,
                                     scale)
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)
    uniform = v[2].float().mean(0).expand(t, d)
    assert (o[2].float() - uniform).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deberta_fwd_is_deterministic(cuda_device, dtype):
    """Two forward calls on the same inputs give bit-identical outputs (no
    atomics), whether the mask is int, bool or bytes."""
    q, k, v, pk, pq, mask, _ = _deberta_bwd_inputs(cuda_device, dtype, 8,
                                                   256, 384)
    first = DA.deberta_attention(q, k, v, pk, pq, mask, 6, 0.1)
    for m in (mask, mask.bool(), DA.key_bytes(mask)):
        again = DA.deberta_attention(q, k, v, pk, pq, m, 6, 0.1)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


def test_deberta_bwd_refuses_what_it_does_not_take(cuda_device):
    q, k, v, pk, pq, mask, do = _deberta_bwd_inputs(cuda_device,
                                                    torch.float32, 2, 64, 128)
    with pytest.raises(ValueError, match="do must be"):
        DA.deberta_attention_bwd(q, k, v, pk, pq, mask, do.bfloat16(), 2, 0.1)
    with pytest.raises(ValueError, match="head dims"):
        DA.deberta_attention_bwd(q, k, v, pk, pq, mask, do, 1, 0.1)
    with pytest.raises(ValueError, match="multiple of 64"):
        DA.deberta_attention_bwd(
            *(x[:, :32].contiguous() for x in (q, k, v)),
            pk[:64].contiguous(), pq[:64].contiguous(), mask[:, :32],
            do[:, :32].contiguous(), 2, 0.1)
    # a view 4 bytes into its storage: contiguous, not 16-byte aligned
    flat = torch.zeros(q.numel() + 1, device=cuda_device)
    odd = flat[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        DA.deberta_attention_bwd(odd, k, v, pk, pq, mask, do, 2, 0.1)


def _swin_train_inputs(dev, dtype, nw, b, c, heads, n=64, seed=5):
    """q' (normalized, times a logit scale of 10 and log2(e)), k
    (normalized), v, do and a log2-domain position bias in (0, 16)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, b, n, heads, dh)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(nw, b, n, c)

    q = unit(torch.randn(nw, b, n, c, device=dev, generator=g))
    q = (q * 10 * 1.4426950408889634).to(dtype)
    k = unit(torch.randn(nw, b, n, c, device=dev, generator=g)).to(dtype)
    v, do = (torch.randn(nw, b, n, c, device=dev, generator=g).to(dtype)
             for _ in range(2))
    bias = 16 * torch.rand(nw, heads, n, n, device=dev,
                           generator=g) * 1.4426950408889634
    return q, k, v, do, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw,b,c,heads", [
    (64, 8, 128, 4), (16, 8, 256, 8), (4, 8, 512, 16), (1, 8, 1024, 32),
    (64, 7, 128, 4), (64, 7, 256, 8), (16, 1, 256, 8),
    (64, 8, 256, 4), (16, 7, 256, 4)])
def test_swin_train_kernels_match_plain(cuda_device, dtype, nw, b, c, heads):
    """The four Swinv2-base stages at batch 8, then B 7 (one row a CTA, and
    seven rows a CTA at 512 (window, head) pairs), B 1 and head dim 64;
    the forward and the backward twice each, bit-identical."""
    q, k, v, do, bias = _swin_train_inputs(cuda_device, dtype, nw, b, c,
                                           heads)
    before = (SA.train_launches, SA.train_bwd_launches)
    o = SA.swin_window_attention_fwd(q, k, v, bias, heads)
    assert SA.train_launches == before[0] + 1
    grads = SA.swin_window_attention_bwd(q, k, v, bias, do, heads)
    assert SA.train_bwd_launches == before[1] + 1
    again = SA.swin_window_attention_fwd(q, k, v, bias, heads)
    grads_again = SA.swin_window_attention_bwd(q, k, v, bias, do, heads)
    torch.cuda.synchronize()
    assert (SA.train_launches, SA.train_bwd_launches) == (before[0] + 2,
                                                          before[1] + 2)
    assert torch.equal(o, again)
    for name, a, a2 in zip(("dq", "dk", "dv", "dbias"), grads, grads_again):
        assert torch.equal(a, a2), name
    ref = SA.swin_window_attention_plain(q.float(), k.float(), v.float(),
                                         bias, heads)
    assert o.dtype == dtype
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)
    want = SA.swin_window_attention_bwd_plain(
        q.float(), k.float(), v.float(), bias, do.float(), heads)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert a.shape == w.shape, name
        fp32 = name == "dbias" or dtype == torch.float32
        tol = _grad_tol(torch.float32 if fp32 else dtype, w)
        assert (a.float() - w).abs().max().item() <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nw,b,c,heads", [
    (256, 16, 8, 128, 4), (256, 4, 8, 256, 8), (256, 1, 8, 512, 16),
    (256, 4, 3, 256, 4), (576, 16, 2, 128, 4), (576, 1, 3, 512, 16),
    (1024, 4, 2, 128, 4)])
def test_swin_train_kernels_at_large_windows_match_plain(cuda_device, dtype,
                                                         n, nw, b, c, heads):
    """#8 and #9 at windows of 256, 576 and 1024 tokens: the window-16
    stages at batch 8 (one group, and the groups whose dbias parts a last
    launch sums), head dim 64 at B 3, the window-24 stages and a 32 x 32
    window; the forward and the backward twice each, bit-identical; the
    bf16 backward against its mirror (P and dS as hi + lo)."""
    q, k, v, do, bias = _swin_train_inputs(cuda_device, dtype, nw, b, c,
                                           heads, n=n, seed=9)
    before = (SA.train_launches, SA.train_bwd_launches)
    o = SA.swin_window_attention_fwd(q, k, v, bias, heads)
    grads = SA.swin_window_attention_bwd(q, k, v, bias, do, heads)
    again = SA.swin_window_attention_fwd(q, k, v, bias, heads)
    grads_again = SA.swin_window_attention_bwd(q, k, v, bias, do, heads)
    torch.cuda.synchronize()
    assert (SA.train_launches, SA.train_bwd_launches) == (before[0] + 2,
                                                          before[1] + 2)
    assert torch.equal(o, again)
    for name, a, a2 in zip(("dq", "dk", "dv", "dbias"), grads, grads_again):
        assert torch.equal(a, a2), name
    ref = SA.swin_window_attention_plain(q.float(), k.float(), v.float(),
                                         bias, heads)
    assert o.dtype == dtype and torch.isfinite(o.float()).all()
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)
    want = SA.swin_window_attention_bwd_plain(
        q.float(), k.float(), v.float(), bias, do.float(), heads,
        split_weights=dtype == torch.bfloat16)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), grads, want):
        assert a.shape == w.shape, name
        fp32 = name == "dbias" or dtype == torch.float32
        tol = _grad_tol(torch.float32 if fp32 else dtype, w)
        assert (a.float() - w).abs().max().item() <= tol, name


def test_kernel_wrappers_keep_the_graph(cuda_device):
    """With grad enabled no kernel wrapper returns an output cut from the
    graph: the trainable ones carry a grad_fn whose backward reaches the
    inputs, the serving-only #7 raises."""
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def leaf(*shape):
        return torch.randn(*shape, device=cuda_device,
                           generator=g).requires_grad_()

    t, d = 64, 128
    q, k, v = leaf(2, t, d), leaf(2, t, d), leaf(2, t, d)
    pk, pq = leaf(2 * t, d), leaf(2 * t, d)
    o = DA.deberta_attention(q, k, v, pk, pq, None, 4, 0.1)
    assert o.grad_fn is not None
    o.square().sum().backward()
    assert all(x.grad is not None for x in (q, k, v, pk, pq))

    ln = torch.nn.LayerNorm(128).to(cuda_device)
    y, x = leaf(16, 128), leaf(16, 128)
    out = LN.fused_layernorm(ln, y, 1e-5, x)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(p.grad is not None for p in (y, x, ln.weight, ln.bias))

    qs, ks, vs = leaf(4, 2, 64, 128), leaf(4, 2, 64, 128), leaf(4, 2, 64, 128)
    bias = leaf(4, 4, 64, 64)
    o = SA.swin_window_attention(qs, ks, vs, bias, 4)
    assert o.grad_fn is not None
    o.square().sum().backward()
    assert all(p.grad is not None for p in (qs, ks, vs, bias))

    with pytest.raises(RuntimeError, match="no backward"):
        SA.swin_window_attention_infer(qs, ks, vs, bias.detach(),
                                       torch.ones(4, device=cuda_device), 4)


def test_bf16_dropout_step_at_embed_384_runs(cuda_device):
    """The fused-MLP routing takes every D a multiple of 128 up to the
    kernels' cap: at embed_dim 384 (F 1536) the bf16 dropout step runs
    the six MLPs on #3 and #4, the two-launch path above D 256."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(model=ModelConfig(
        text_input_dim=64, image_input_dim=96, embed_dim=384, num_heads=6,
        hidden_dim=16, fused_attn=True), batch_size=4, lr=1e-3)
    tr = Trainer(cfg, device="cuda")
    state = tr.init()
    before = (M.launches, M.bwd_launches)
    batch = synthetic_preembed_batch(np.random.default_rng(0), 4, 128, 64,
                                     64, 96)
    state, aux = tr.train_step(state, tr.shard_batch(batch))
    torch.cuda.synchronize()
    assert (M.launches - before[0], M.bwd_launches - before[1]) == (6, 6)
    assert np.isfinite(float(aux["loss"]))


# -- #4 at the bf16 train step's MLP geometries --------------------------------

# (N, D, F): the step's text-query and image-query MLPs (chip_smoke.py's
# MLP_GEOMS)
MLP_STEP_GEOMS = [(131072, 256, 1024), (16384, 256, 1024)]


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,d,f", MLP_STEP_GEOMS)
def test_mlp_bwd_is_deterministic(cuda_device, rate, n, d, f):
    """Two calls of #4 agree bit for bit: fixed-order sums, no atomics."""
    x, w1, b1, w2, _, dy = _mlp_inputs(cuda_device, n, d, f, seed=3)
    seeds = M.mask_seeds(rate, 0xD1CE)
    first = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
    second = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), first, second):
        assert torch.equal(a, b), name


# -- #3 at a partial row tile and at the text call's row count ----------------

@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,d,f", [(1088, 128, 512), (1088, 256, 1024),
                                   (131072, 128, 512)])
def test_mlp_fwd_is_deterministic_and_matches_plain(cuda_device, rate, n, d,
                                                    f):
    """#3 within MLP_TOL of the plain version, its zeros where the plain
    version's are, and the same bits in two calls: 1088 rows end in a
    partial 128-row tile; 131072 rows are the bf16 step's text call, here
    at D 128."""
    x, w1, b1, w2, b2, _ = _mlp_inputs(cuda_device, n, d, f, seed=5)
    seeds = M.mask_seeds(rate, 0xF00D + n)
    first = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
    second = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    want = M.fused_mlp_plain(x, w1, b1, w2, b2, seeds, rate)
    assert _rel_err(first, want) <= MLP_TOL
    if rate:
        assert torch.equal(first == 0, want == 0)


# -- the fusion step's wider widths: --embed_dim 384 | 512, 4 heads ------------

# (B, T, S): the step's four attention geometries at batch 256
WIDE_ATTN = [(256, 512, 512), (256, 64, 64), (256, 512, 64), (256, 64, 512)]


@pytest.mark.parametrize("dh", [96, 112])
@pytest.mark.parametrize("b,t,s", WIDE_ATTN)
def test_flash_at_wide_head_dims_matches_plain(cuda_device, dh, b, t, s):
    """#1 and #2 over 4 heads of dh 96 (--embed_dim 384) and 112 at the
    step's geometries, bf16 and fp32, rates 0.1 and 0, against the plain
    versions: o within TOL, each gradient within 1e-4 (fp32) or 2^-7
    (bf16) of its largest |value|."""
    d, h = 4 * dh, 4
    g = torch.Generator(device=cuda_device).manual_seed(dh + t + s)
    q32, k32, v32, do32 = (torch.randn(b, n, d, device=cuda_device,
                                       generator=g) for n in (t, s, s, t))
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
        for rate in (0.1, 0.0):
            o, lse = A.flash_attention(q, k, v, h, None, rate, 5)
            got = A.flash_attention_bwd(q, k, v, o, lse, do, h, None, rate,
                                        5)
            torch.cuda.synchronize()
            o_p, _ = A.flash_attention_plain(q.float(), k.float(), v.float(),
                                             h, None, rate, 5)
            assert (o.float() - o_p).abs().max().item() < TOL[dtype]
            want = A.flash_attention_bwd_plain(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                h, None, rate, 5)
            tol = 1e-4 if dtype == torch.float32 else 2 ** -7
            for a, w in zip(got, want):
                assert _rel_err(a, w) <= tol
            del o, lse, got, want, o_p


# (N, D, F): the step's text-query and image-query MLPs at both widths
MLP_WIDE_GEOMS = [(131072, 384, 1536), (16384, 384, 1536),
                  (131072, 512, 2048), (16384, 512, 2048)]


@pytest.mark.parametrize("rate", [0.1, 0.0])
@pytest.mark.parametrize("n,d,f", MLP_WIDE_GEOMS)
def test_mlp_kernels_match_plain_at_wide_d(cuda_device, rate, n, d, f):
    """#12 bit for bit, #3 and #4 within MLP_TOL of each output's largest
    |value|, and each twice bit for bit, at the step's wider geometries."""
    x, w1, b1, w2, b2, dy = _mlp_inputs(cuda_device, n, d, f, seed=9)
    seeds = M.mask_seeds(rate, 0xCAFE + d)
    m1, m2 = M.mlp_masks(n, d, f, seeds, rate, cuda_device)
    p1, p2 = M.mlp_masks_plain(n, d, f, seeds, rate, cuda_device)
    assert torch.equal(m1, p1) and torch.equal(m2, p2)
    del m1, m2, p1, p2
    y = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
    got = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
    again = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
    torch.cuda.synchronize()
    assert torch.equal(y, M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert _rel_err(y, M.fused_mlp_plain(x, w1, b1, w2, b2, seeds,
                                         rate)) <= MLP_TOL
    want = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, seeds, rate)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= MLP_TOL, name


@pytest.mark.parametrize("embed", [384, 512])
def test_bf16_step_at_wide_embed_runs_every_kernel(cuda_device, embed):
    """A bf16 dropout step at --embed_dim 384 | 512 --num_heads 4 runs #1
    and #2 eight times each, #3 and #4 six times each, and the heads'
    dropouts on #5, and nothing on the explicit attention path."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(model=ModelConfig(
        text_input_dim=64, image_input_dim=96, embed_dim=embed, num_heads=4,
        hidden_dim=16, fused_attn=True), batch_size=4, lr=1e-3)
    tr = Trainer(cfg, device="cuda")
    state = tr.init()
    batch = synthetic_preembed_batch(np.random.default_rng(1), 4, 128, 64,
                                     64, 96)
    counts = (A.launches, A.bwd_launches, M.launches, M.bwd_launches,
              D.launches)
    explicit = A.explicit_attention
    calls = []
    A.explicit_attention = lambda *a, **k: calls.append(1) or explicit(
        *a, **k)
    try:
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        torch.cuda.synchronize()
    finally:
        A.explicit_attention = explicit
    ran = tuple(c - b for c, b in zip(
        (A.launches, A.bwd_launches, M.launches, M.bwd_launches,
         D.launches), counts))
    assert ran == (8, 8, 6, 6, 8) and not calls
    assert np.isfinite(float(aux["loss"]))


# -- attention geometries the kernels do not take take the explicit path ------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fusion_step_at_head_dim_128_matches_the_explicit_path(cuda_device,
                                                               dtype):
    """embed 512 over 4 heads (dh 128) with fused_attn: the flash kernels
    run (8 forward and 8 backward launches a step), and the step is the
    explicit path's (fused_attn off), same init and seed. fp32: loss within
    1e-5 relative, each leaf within 1e-4 of its largest |g| (3xTF32 against
    fp32 sums in another order; no leaf held below 1e-3 of the largest
    gradient). bf16: the kernels round P unnormalized where the explicit
    path rounds the normalized weights, and at batch 4 the heads' ReLU
    gates carry those roundings into the gradient, so the two bf16 steps
    are each held against the fp32 explicit step: the kernels' loss within
    1e-3 relative of the bf16 explicit loss, and the kernels' gradient (as
    one vector) no further from the fp32 step's than twice the bf16
    explicit path's distance (a wrong mask or weight moves it by O(1))."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    batch = synthetic_preembed_batch(np.random.default_rng(0), 4, 128, 64,
                                     64, 96)
    runs = [(True, dtype), (False, dtype)]
    if dtype == "bfloat16":
        runs.append((False, "float32"))
    out = {}
    for fused, dt in runs:
        cfg = TrainConfig(model=ModelConfig(
            text_input_dim=64, image_input_dim=96, embed_dim=512,
            num_heads=4, hidden_dim=16, fused_attn=fused,
            compute_dtype=dt), batch_size=4, lr=1e-3)
        tr = Trainer(cfg, device="cuda")
        state = tr.init()
        was = (A.launches, A.bwd_launches)
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        torch.cuda.synchronize()
        ran = (A.launches - was[0], A.bwd_launches - was[1])
        assert ran == ((8, 8) if fused else (0, 0))
        out[fused, dt] = (float(aux["loss"]),
                          {n: p.grad.detach().float().clone()
                           for n, p in state.params.named_parameters()})
    (lf, gf), (le, ge) = out[True, dtype], out[False, dtype]
    assert np.isfinite(lf)
    if dtype == "float32":
        assert abs(lf - le) <= 1e-5 * abs(le)
        floor = 1e-3 * max(w.abs().max().item() for w in ge.values())
        for n, w in ge.items():
            assert (gf[n] - w).abs().max().item() <= 1e-4 * max(
                w.abs().max().item(), floor), n
    else:
        assert abs(lf - le) <= 1e-3 * abs(le)
        g32 = out[False, "float32"][1]

        def gap(g):
            return torch.cat([(g[n] - w).flatten()
                              for n, w in g32.items()]).norm().item()

        assert gap(gf) <= 2.0 * gap(ge)


def test_swin_window_16_matches_the_explicit_path(cuda_device):
    """SwinConfig(window_size=16), fp32: with fused_attn and fused_train on
    the two blocks' window attentions (256 tokens, one shifted) run the
    fine-tuning kernels -- #8 forward, #9 under autograd -- and give the
    explicit path's output and gradients."""
    from mmd_tpu_torch.models import swin as TS
    base = TS.SwinConfig(image_size=128, patch_size=4, embed_dim=64,
                         depths=(2,), num_heads=(2,), window_size=16,
                         pretrained_window_sizes=(0,),
                         compute_dtype="float32")
    gen = torch.Generator(cuda_device).manual_seed(1)
    images = torch.rand(2, 128, 128, 3, device=cuda_device, generator=gen)
    probe = torch.randn(2, 1024, 64, device=cuda_device, generator=gen)
    out = {}
    for fused in (True, False):
        cfg = dataclasses.replace(base, fused_attn=fused, fused_train=fused)
        params = TS.init_swin(torch.Generator().manual_seed(0), cfg).to(
            cuda_device)
        was = (SA.launches, SA.train_launches, SA.train_bwd_launches)
        with torch.no_grad():
            served = TS.swin_forward(params, cfg, images)
        y = TS.swin_forward(params, cfg, images)
        (y * probe).sum().backward()
        torch.cuda.synchronize()
        ran = tuple(a - b for a, b in zip(
            (SA.launches, SA.train_launches, SA.train_bwd_launches), was))
        # fused_train takes #8 in the forward with or without grad
        assert ran == ((0, 4, 2) if fused else (0, 0, 0))
        out[fused] = (served, y.detach(),
                      {n: p.grad.detach().clone()
                       for n, p in params.named_parameters()})
    (sf, yf, gf), (se, ye, ge) = out[True], out[False]
    assert torch.isfinite(yf).all()
    # fp32 sums in another order (3xTF32 products, exp2 of log2-domain
    # scores): the outputs and each gradient leaf within 1e-4 of their
    # largest |value| (no leaf's true gradient is zero: Swinv2's k has no
    # bias); the gaps are printed, relative, for `pytest -s`
    gaps = {n: ((gf[n] - w).abs().max() / w.abs().max()).item()
            for n, w in ge.items()}
    gaps.update({what: ((got - want).abs().max()
                        / want.abs().max()).item()
                 for what, got, want in (("served", sf, se), ("y", yf, ye))})
    worst = max(gaps, key=gaps.get)
    print(f"window 16, fused vs explicit: largest gap {gaps[worst]:.3e} of "
          f"its leaf's largest |value| ({worst}); outputs {gaps['served']:.3e}"
          f" served, {gaps['y']:.3e} under autograd")
    for n, gap in gaps.items():
        assert gap <= 1e-4, n


def test_deberta_head_dim_128_matches_the_explicit_path(cuda_device):
    """A DeBERTa config with dh 128 (hidden 256 over 2 heads): no
    disentangled-attention kernel runs, and the encoding is the explicit
    path's."""
    from mmd_tpu_torch.models import deberta as TD
    base = TD.DebertaConfig(vocab_size=128, hidden_size=256, num_layers=2,
                            num_heads=2, intermediate_size=256,
                            max_position=64, position_buckets=16)
    assert not TD.use_fused_attn(base, 64, cuda_device)
    ids = torch.randint(0, 128, (2, 64), device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(2))
    mask = torch.ones(2, 64, dtype=torch.int32, device=cuda_device)
    mask[1, 40:] = 0
    out = {}
    for fused in (True, False):
        cfg = dataclasses.replace(base, fused_attn=fused)
        params = TD.init_deberta(torch.Generator().manual_seed(0), cfg).to(
            cuda_device)
        was = (DA.launches, DA.bwd_launches)
        h = TD.deberta_encode(params, cfg, ids, mask)
        h.square().mean().backward()
        torch.cuda.synchronize()
        assert (DA.launches, DA.bwd_launches) == was
        out[fused] = (h.detach(), params["rel_embeddings"].grad.clone())
    assert torch.isfinite(out[True][0]).all()
    assert torch.equal(out[True][0], out[False][0])
    # the table's gradient is a scatter-add, summed in no fixed order
    top = out[False][1].abs().max().item()
    assert (out[True][1] - out[False][1]).abs().max().item() <= 1e-5 * top


# -- evidence retrieval: the re-rank geometry, dense and int8 top-k, ResNet --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_rerank_geometry(cuda_device, dtype):
    """#1 as a text search's cross-encoder re-rank runs it: 50 pairs,
    T = S 256, 12 heads of dh 32, padded key tails."""
    g = torch.Generator(device=cuda_device).manual_seed(18)
    q, k, v = (torch.randn(50, 256, 384, device=cuda_device, generator=g)
               .to(dtype) for _ in range(3))
    lengths = torch.linspace(24, 256, 50, device=cuda_device).round().long()
    mask = torch.arange(256, device=cuda_device)[None] < lengths[:, None]
    before = A.launches
    o, lse = A.flash_attention(q, k, v, 12, mask)
    torch.cuda.synchronize()
    assert A.launches == before + 1
    o_p, lse_p = A.flash_attention_plain(q.float(), k.float(), v.float(), 12,
                                         mask)
    assert (o.float() - o_p).abs().max().item() < TOL[dtype]
    assert (lse - lse_p).abs().max().item() < 1e-3


def _topk_data(q, n, d, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    c = torch.randn(n, d, generator=g)
    c[n // 2] = c[3]                            # a duplicated row
    qs = torch.randn(q, d, generator=g)
    qs[0] = c[3] + 1e-3 * qs[0]
    return qs, c


@pytest.mark.parametrize("normalize", [True, False])
def test_dense_topk_on_the_card_matches_the_cpu(cuda_device, normalize):
    """bf16 operands, fp32 scores: the same indices (ties lower index
    first: the duplicated row's twin after it) and scores within 1e-5 of
    the largest."""
    from mmd_tpu_torch.ops import topk as T
    q, c = _topk_data(5, 4000, 768)
    q, c = q.bfloat16(), c.bfloat16()
    s_cpu, i_cpu = T.dense_topk(q, c, 25, normalize)
    s, i = T.dense_topk(q.to(cuda_device), c.to(cuda_device), 25, normalize)
    assert s.dtype == torch.float32
    assert torch.equal(i.cpu(), i_cpu)
    assert i_cpu[0, :2].tolist() == [3, 2000]
    top = s_cpu.abs().max().item()
    assert (s.cpu() - s_cpu).abs().max().item() <= 1e-5 * top


@pytest.mark.parametrize("q_rows", [1, 64])
def test_topk_lower_index_first_on_the_card_matches_the_cpu(cuda_device,
                                                           q_rows):
    """The stable sort on the card at the image corpus's N: integer-valued
    scores (ties everywhere, zeros of both signs) give the CPU's values and
    indices, lower index first among ties."""
    from mmd_tpu_torch.ops import topk as T
    rng = np.random.default_rng(q_rows)
    s = rng.integers(-3, 4, (q_rows, 41_256)).astype(np.float32)
    s[:, ::7] *= -0.0
    s = torch.from_numpy(s)
    v_cpu, i_cpu = T.topk_lower_index_first(s, 20)
    v, i = T.topk_lower_index_first(s.to(cuda_device), 20)
    assert torch.equal(i.cpu(), i_cpu)
    assert torch.equal(v.cpu().view(torch.int32), v_cpu.view(torch.int32))
    assert (i_cpu.diff(dim=-1) > 0).all()       # all 3s: ascending index


@pytest.mark.parametrize("q_rows", [1, 5, 64])
def test_dense_topk_int8_on_the_card_matches_the_cpu(cuda_device, q_rows):
    """torch._int_mm on the card (the corpus supplies the rows, queries
    padded to a multiple of 8). From the same normalized rows, codes and
    scales equal the CPU's bit for bit; the query's norm may differ by an
    ulp between the devices, so indices are equal and scores within
    1e-6."""
    from mmd_tpu_torch.ops import topk as T
    q, c = _topk_data(q_rows, 3000, 2048, seed=q_rows)
    cn = T.l2_normalize(c)
    c8, cs = T.quantize_rows_int8(cn)
    g8, gs = T.quantize_rows_int8(cn.to(cuda_device))
    assert torch.equal(g8.cpu(), c8) and torch.equal(gs.cpu(), cs)
    s_cpu, i_cpu = T.dense_topk_int8(q, c8, cs, 10)
    s, i = T.dense_topk_int8(q.to(cuda_device), g8, gs, 10)
    assert torch.equal(i.cpu(), i_cpu)
    assert i_cpu[0, :2].tolist() == [3, 1500]
    assert (s.cpu() - s_cpu).abs().max().item() <= 1e-6
    raw = T.int8_products(c8[:5].to(cuda_device), c8[:12].to(cuda_device))
    assert torch.equal(raw.cpu(), c8[:5].int() @ c8[:12].int().T)


def test_resnet50_on_the_card_matches_the_cpu(cuda_device):
    """ResNet50 in fp32 (TF32 off) at 224 px, batch 2: features within
    1e-4 of the largest."""
    from mmd_tpu_torch.models import resnet as R
    cfg = R.ResNetConfig(compute_dtype="float32")
    params = R.init_resnet(torch.Generator().manual_seed(7), cfg)
    x = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = R.resnet_features(params, x, cfg)
        got = R.resnet_features(params.to(cuda_device), x.to(cuda_device),
                                cfg).cpu()
    assert got.shape == (2, 2048)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("size_in,size_out", [(256, 224), (32, 24), (32, 48)])
def test_resize_bilinear_on_the_card_matches_the_cpu(cuda_device, size_in,
                                                     size_out):
    """The fused pipeline's bank resize (pipelines/fused.py): floats within
    1e-5 of the 255 range, uint8 within one level."""
    from mmd_tpu_torch.ops.image_ops import resize_bilinear, resize_uint8
    x = torch.from_numpy(np.random.default_rng(size_out).integers(
        0, 256, (4, size_in, size_in, 3)).astype(np.uint8))
    want = resize_bilinear(x, size_out)
    got = resize_bilinear(x.to(cuda_device), size_out).cpu()
    assert (got - want).abs().max().item() <= 1e-5 * 255
    d8 = (resize_uint8(x.to(cuda_device), size_out).cpu().int()
          - resize_uint8(x, size_out).int())
    assert d8.abs().max().item() <= 1


def test_ingest_on_the_card_equals_the_raw_store(cuda_device, tmp_path,
                                                 monkeypatch):
    """pipelines/fused.ingest_split on the card with chunks of 8 (fewer
    than the split's rows: the pinned staging buffers are refilled behind
    their events while non-blocking copies fly): every bank column equals
    the raw store of the same CSV, and the chunks handed to a hook that
    keeps them still hold their rows afterwards."""
    import pandas as pd

    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
    from mmd_tpu_torch.models.frozen import FrozenEncoders
    from mmd_tpu_torch.pipelines import fused as FU
    from mmd_tpu_torch.pipelines import raw_store as RS
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv
    synthetic_factify_tree(tmp_path, n_train=40, n_test=4, seed=3)
    monkeypatch.setenv("MMD_TPU_ROOT", str(tmp_path))
    csv = preprocess_csv("train", tmp_path)
    df = pd.read_csv(csv)
    tok = WordPieceTokenizer.train(
        df[["claim", "evidence"]].stack().astype(str).tolist(), 200)
    enc = FrozenEncoders(tok, None, None, None, None)
    kept = []
    bank = FU.ingest_split(csv, enc, max_length=32, image_size=64, chunk=8,
                           keep_images=False, io_workers=2, sync_every=100,
                           device=cuda_device,
                           on_chunk=lambda imgs, s, n: kept.append(imgs))
    store = RS.build_raw_store(str(csv), tok, max_length=32, image_size=64,
                               batch_size=5, io_workers=2)
    assert 8 < bank.n == len(store) and bank.n + bank.skipped == 40
    torch.cuda.synchronize()
    for col in ("claim_ids", "claim_mask", "doc_ids", "doc_mask", "labels"):
        assert bank.data[col].device.type == "cuda"
        np.testing.assert_array_equal(bank.data[col][:bank.n].cpu().numpy(),
                                      store.col(col), err_msg=col)
    for kind in ("claim", "doc"):
        got = torch.cat([c[kind] for c in kept])[:bank.n].cpu().numpy()
        np.testing.assert_array_equal(got, store.col(f"{kind}_image"))


# -- multi-device serving: #1 at the sequence-parallel geometries, a world
# of 2 gloo ranks sharing the card ------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tq", [256, 128])
def test_kernel_at_sequence_parallel_geometries(cuda_device, dtype, tq):
    """#1 with a rank's T/sp query rows against all T 512 keys (SP 2 and 4
    at the served batch of 16), under the replicated key mask: padded
    tails, a row with one valid key, a row with none."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn(16, tq, 384, device=cuda_device, generator=g)
    k, v = (torch.randn(16, 512, 384, device=cuda_device, generator=g)
            for _ in range(2))
    lengths = torch.randint(1, 513, (16,), device=cuda_device,
                            generator=g)
    lengths[0], lengths[1], lengths[2] = 512, 1, 0
    mask = (torch.arange(512, device=cuda_device)[None]
            < lengths[:, None]).int()
    before = A.launches
    o, lse = A.flash_attention(q.to(dtype), k.to(dtype), v.to(dtype), 6,
                               mask)
    torch.cuda.synchronize()
    o_p, lse_p = A.flash_attention_plain(q.to(dtype).float(),
                                         k.to(dtype).float(),
                                         v.to(dtype).float(), 6, mask)
    assert A.launches == before + 1 and o.shape == q.shape
    assert (o.float() - o_p).abs().max().item() < TOL[dtype]
    fin = torch.isfinite(lse_p)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse[fin] - lse_p[fin]).abs().max().item() < 1e-3
    assert torch.all(o[2] == 0) and torch.all(torch.isneginf(lse[2]))


def _parallel_cases():
    """A BERT-class stack on the flash kernel and a DeBERTa stack on #10
    (hidden 128 passes its gate), fp32, seeded, with padded inputs."""
    from mmd_tpu_torch.models import deberta as TD
    from mmd_tpu_torch.models import text_encoder as TTE
    bert = dataclasses.replace(TTE.TINY_TEST, hidden_size=128, num_heads=4,
                               intermediate_size=256, num_layers=2,
                               fused_attn=True)
    deb = dataclasses.replace(TD.DEBERTA_TEST, hidden_size=128, num_heads=4,
                              intermediate_size=256, max_position=128,
                              position_buckets=32)
    gen = torch.Generator().manual_seed(5)
    ids = torch.randint(2, 100, (4, 128), generator=gen)
    mask = (torch.arange(128)[None]
            < torch.tensor([128, 100, 65, 3])[:, None]).int()
    return {"bert": (bert, TTE.init_text_encoder(gen, bert), ids, mask),
            "deberta": (deb, TD.init_deberta(gen, deb), ids, mask)}


def _serve_parallel_rank(rank, world, dev):
    from mmd_tpu_torch.core.mesh import make_mesh
    from mmd_tpu_torch.models.frozen import text_encode_parallel
    from mmd_tpu_torch.parallel import collectives as C
    from mmd_tpu_torch.parallel.tp import shard_encoder
    mesh = make_mesh(world, device=dev)
    out = {}
    with torch.no_grad():
        for name, (cfg, params, ids, mask) in _parallel_cases().items():
            for mode in ("sp", "tp"):
                p = (shard_encoder(params, mesh) if mode == "tp"
                     else params.to(dev))
                before = (A.launches, DA.launches)
                y = text_encode_parallel(p, cfg, ids.to(dev), mask.to(dev),
                                         mesh=mesh, mode=mode)
                out[name, mode] = (y.cpu(), A.launches - before[0],
                                   DA.launches - before[1])
    out["staged_bytes"] = C.staged_bytes
    return out


def test_two_gloo_ranks_on_the_card_match_the_unsplit_encode(cuda_device):
    """A world of 2 gloo ranks sharing the card: the SP and TP encodes
    (#1 at T/2 queries, #1 and #10 at 2 of 4 heads) match the unsplit
    encode on the card within 1e-4, and the collectives staged their
    tensors through host memory."""
    from mmd_tpu_torch.models.frozen import text_encode
    from mmd_tpu_torch.parallel.launch import spawn
    outs = spawn(_serve_parallel_rank, 2, "gloo", "cuda", timeout_s=600)
    with torch.no_grad():
        for name, (cfg, params, ids, mask) in _parallel_cases().items():
            want = text_encode(params.to(cuda_device), cfg,
                               ids.to(cuda_device), mask.to(cuda_device))
            want = want.cpu()
            for rank, out in enumerate(outs):
                for mode in ("sp", "tp"):
                    y, flash, deb = out[name, mode]
                    err = (y - want).abs().max().item()
                    assert err < 1e-4, (name, mode, rank, err)
                    # DeBERTa's SP attention takes the explicit path
                    if name == "bert":
                        assert flash > 0
                    elif mode == "tp":
                        assert deb > 0
    assert all(out["staged_bytes"] > 0 for out in outs)


def test_nccl_refuses_two_ranks_on_one_card(cuda_device):
    from mmd_tpu_torch.parallel.launch import spawn
    if torch.cuda.device_count() >= 2:
        pytest.skip("checks the refusal on a machine with one card")
    with pytest.raises(RuntimeError, match="one rank a card"):
        spawn(_serve_parallel_rank, 2, "nccl", "cuda", timeout_s=60)


def _mlp_tp_inputs():
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(2, 256, 256, generator=gen)
    w1 = torch.randn(256, 1024, generator=gen) * 0.05
    b1 = torch.randn(1024, generator=gen) * 0.1
    w2 = torch.randn(1024, 256, generator=gen) * 0.05
    b2 = torch.randn(256, generator=gen) * 0.1
    return x, w1, b1, w2, b2


def _mlp_tp_rank(rank, world, dev):
    from mmd_tpu_torch.core.mesh import make_mesh
    from mmd_tpu_torch.parallel import collectives as C
    mesh = make_mesh(world, device=dev)
    x, w1, b1, w2, b2 = (t.to(dev) for t in _mlp_tp_inputs())
    f = w1.shape[1] // world
    cols = slice(rank * f, (rank + 1) * f)
    before = M.launches
    with torch.no_grad():
        y = M.fused_mlp(x, w1[:, cols], b1[cols], w2[cols], b2, 0.0, None,
                        torch.bfloat16, tp_mesh=mesh)
    return y.float().cpu(), M.launches - before, C.staged_bytes


def test_fused_mlp_tp_over_two_gloo_ranks_matches_the_kernel(cuda_device):
    """fused_mlp(tp_mesh=) over a world of 2 gloo ranks sharing the card,
    F 1024 split into two 512-wide slices at rate 0: each rank's #3 on its
    slice with b2 / 2, the partials summed in fp32, against the unsplit
    kernel within two bf16 roundings (2^-6 of the largest |y|: each
    partial's and the sum's)."""
    from mmd_tpu_torch.parallel.launch import spawn
    outs = spawn(_mlp_tp_rank, 2, "gloo", "cuda", timeout_s=600)
    x, w1, b1, w2, b2 = (t.to(cuda_device) for t in _mlp_tp_inputs())
    with torch.no_grad():
        want = M.fused_mlp(x, w1, b1, w2, b2, 0.0, None,
                           torch.bfloat16).float().cpu()
    for rank, (y, launches, staged) in enumerate(outs):
        err = (y - want).abs().max().item()
        assert err <= 2.0 ** -6 * want.abs().max().item(), (rank, err)
        assert launches == 1 and staged > 0, (rank, launches, staged)
