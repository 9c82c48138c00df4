"""Port tests that need an NVIDIA GPU (marker `cuda`); they skip without one.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, where tests/conftest.py (which imports JAX) cannot load:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It holds each hand-written kernel against its plain PyTorch version at the
serving paths' geometries -- flash attention, (residual +) LayerNorm,
Swinv2 window attention and DeBERTa disentangled attention -- and the
small serving paths on the card against the same paths on the CPU.
Tolerances: fp32 within 1e-4 (summation order, exp2f); bf16 within one
bf16 step at the largest |output| (the output is rounded to bf16 once).
"""

import numpy as np
import pytest
import torch

from mmd_tpu_torch.ops import attention as A
from mmd_tpu_torch.ops import deberta_attention as DA
from mmd_tpu_torch.ops import ln as LN
from mmd_tpu_torch.ops import swin_attention as SA

pytestmark = pytest.mark.cuda

B = 4
# (T, S, D, H, masked): text, ViT, fusion self and cross, ragged
GEOMETRIES = [(512, 512, 384, 6, True), (64, 64, 1024, 16, False),
              (512, 64, 256, 8, False), (64, 512, 256, 8, False),
              (100, 130, 128, 2, True)]
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c,residual", [
    (4096, 128, False), (2048, 256, True), (512, 1024, True), (24, 384, True)])
def test_layernorm_kernel_matches_plain(cuda_device, dtype, rows, c,
                                        residual):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    ln = torch.nn.LayerNorm(c).to(cuda_device)
    with torch.no_grad():
        ln.weight.normal_(generator=g)
        ln.bias.normal_(generator=g)
    y = torch.randn(rows, c, device=cuda_device, generator=g).to(dtype)
    x = (torch.randn(rows, c, device=cuda_device, generator=g).to(dtype)
         if residual else None)
    before = LN.launches
    with torch.no_grad():
        out = LN.fused_layernorm(ln, y, 1e-5, x)
        torch.cuda.synchronize()
        ref = LN.fused_layernorm_plain(ln, y.float(), 1e-5,
                                       None if x is None else x.float())
    assert LN.launches == before + 1 and out.dtype == dtype
    assert (out.float() - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw,c,heads,shared_bias", [
    (16, 128, 4, False), (4, 256, 8, True), (1, 1024, 32, True),
    (4, 256, 4, False)])
def test_swin_kernel_matches_plain(cuda_device, dtype, nw, c, heads,
                                   shared_bias):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn(nw, B, 64, c, device=cuda_device, generator=g)
               .to(dtype) for _ in range(3))
    bias = torch.randn(1 if shared_bias else nw, heads, 64, 64,
                       device=cuda_device, generator=g) * 4
    scale = torch.rand(heads, device=cuda_device, generator=g) * 30 + 1
    before = SA.launches
    o = SA.swin_window_attention_infer(q, k, v, bias, scale, heads)
    torch.cuda.synchronize()
    ref = SA.swin_window_attention_infer_plain(q.float(), k.float(),
                                               v.float(), bias, scale, heads)
    assert SA.launches == before + 1 and o.dtype == dtype
    assert (o.float() - ref).abs().max().item() <= _tol(dtype, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,heads", [(512, 384, 6), (128, 128, 4),
                                       (64, 64, 2)])
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
    with pytest.raises(ValueError, match="multiple of 128"):
        LN.fused_layernorm(ln, torch.zeros(8, 2048, device=cuda_device))
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
