"""Port tests that need an NVIDIA GPU (marker `cuda`); they skip without one.

This file imports no JAX, so it also runs on a machine with a card and no
JAX, where tests/conftest.py (which imports JAX) cannot load:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

It holds each hand-written kernel against its plain PyTorch version at the
serving paths' geometries -- flash attention, (residual +) LayerNorm,
Swinv2 window attention and DeBERTa disentangled attention -- and the
small serving paths on the card against the same paths on the CPU; and
the training kernels -- dropout (bit for bit), flash attention with
dropout and its backward, the fused GELU-MLP forward and backward and their
mask oracle -- and small fp32 and bf16 train steps on the card against the
same steps on the CPU; and the fine-tuning kernels -- the DeBERTa attention
backward and the Swin window attention's fine-tuning forward and backward,
dbias included -- with the autograd graph kept through every trainable
wrapper and the fused-MLP routing limited to the kernels' widths.
Tolerances: fp32 within 1e-4 (summation order, exp2f); bf16 within one
bf16 step at the largest |output| (the output is rounded to bf16 once);
gradients relative to their largest |value| (1e-4 in fp32); the fused MLP
within 2^-7 of each output's largest |value| (one bf16 rounding of the
output and of h, dyb and dab inside).
"""

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
                                   (1000, 256, 1024), (1, 128, 128)])
def test_mlp_kernels_match_plain(cuda_device, rate, n, d, f):
    """#12 bit for bit; #3 and #4 within MLP_TOL of each output's scale."""
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
    with pytest.raises(ValueError, match="D in"):
        M.fused_mlp_fwd(x[:, :64].contiguous(), w1[:64].contiguous(), b1,
                        w2[:, :64].contiguous(), b2[:64], seeds, 0.1)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d,heads", [(256, 384, 6), (128, 128, 4),
                                       (64, 64, 2)])
def test_deberta_bwd_kernel_matches_plain(cuda_device, dtype, t, d, heads):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v, do = (torch.randn(B, t, d, device=cuda_device, generator=g)
                   .to(dtype) for _ in range(4))
    pk, pq = (torch.randn(2 * t, d, device=cuda_device, generator=g)
              .to(dtype) for _ in range(2))
    lengths = torch.tensor([t, t - 11, 1, 0], device=cuda_device)
    mask = (torch.arange(t, device=cuda_device)[None]
            < lengths[:, None]).int()
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
        assert (a.float() - w).abs().max().item() <= tol, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nw,c,heads", [(64, 128, 4), (16, 256, 8),
                                        (4, 512, 16), (1, 1024, 32)])
def test_swin_train_kernels_match_plain(cuda_device, dtype, nw, c, heads):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    dh = c // heads

    def unit(x):
        x = x.reshape(nw, B, 64, heads, dh)
        return (x / x.norm(dim=-1, keepdim=True)).reshape(nw, B, 64, c)

    q = unit(torch.randn(nw, B, 64, c, device=cuda_device, generator=g))
    q = (q * 10 * 1.4426950408889634).to(dtype)
    k = unit(torch.randn(nw, B, 64, c, device=cuda_device, generator=g)
             ).to(dtype)
    v, do = (torch.randn(nw, B, 64, c, device=cuda_device, generator=g)
             .to(dtype) for _ in range(2))
    bias = 16 * torch.rand(nw, heads, 64, 64, device=cuda_device,
                           generator=g) * 1.4426950408889634
    before = (SA.train_launches, SA.train_bwd_launches)
    o = SA.swin_window_attention_fwd(q, k, v, bias, heads)
    grads = SA.swin_window_attention_bwd(q, k, v, bias, do, heads)
    torch.cuda.synchronize()
    assert (SA.train_launches, SA.train_bwd_launches) == (before[0] + 1,
                                                          before[1] + 1)
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
    """The fused-MLP routing takes only the widths the kernels are built
    for: at embed_dim 384 the bf16 dropout step runs the unfused MLP."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = TrainConfig(model=ModelConfig(
        text_input_dim=64, image_input_dim=96, embed_dim=384, num_heads=6,
        hidden_dim=16, fused_attn=True), batch_size=4, lr=1e-3)
    tr = Trainer(cfg, device="cuda")
    state = tr.init()
    before = M.launches
    batch = synthetic_preembed_batch(np.random.default_rng(0), 4, 128, 64,
                                     64, 96)
    state, aux = tr.train_step(state, tr.shard_batch(batch))
    torch.cuda.synchronize()
    assert M.launches == before and np.isfinite(float(aux["loss"]))
