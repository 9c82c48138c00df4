"""Smoke run of the PyTorch port's serving, training and fine-tuning paths
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:
  1. device   a CUDA device, its name and power limit (nvidia-smi), TF32 off
  2. build    nvcc builds the eleven kernel libraries from ops/csrc/, all at
              once
  3. kernels  each kernel against its plain PyTorch version on the card, at
              every geometry of the paths that run it, bf16 and fp32: max-abs
              error against its tolerance; kernel, plain and library times
              from CUDA events; the bound (the least time the card could
              take: bytes over 3.35 TB/s or operations over the card's peak
              for the timed dtype -- 989 TFLOP/s for bf16 on the tensor
              cores, 67 TFLOP/s for fp32, which has no tensor-core rate
              without TF32 (H100 SXM data sheet) -- whichever is larger),
              all beside the card's name
     * flash_attn_fwd        exact zeros for a row with no valid key, lse
     * layernorm             (residual +) LayerNorm, the 53 of a Swinv2 forward
     * swin_window_attn      Swinv2 window attention, the 24 of a forward
     * deberta_attn_fwd      DeBERTa attention, the uniform row of a row
                             with no valid key
     * dropout               elementwise dropout at each dropout geometry of
                             the train step: bit-identical to its plain
                             version, kept fraction within 4 sigma of 1 - rate
     * flash_attn_fwd        with attention dropout at the fusion model's
       (train)               four geometries, batch 256; rate 0 unchanged
     * flash_attn_bwd        dq, dk, dv at the same geometries with and
                             without dropout, and the masked text geometry
                             with a row with no valid key
     * mlp_masks, mlp_fwd,   the fused MLP at the bf16 train step's two MLP
       mlp_bwd               geometries, rate 0.1 and 0: the dumped masks
                             bit-identical to their plain version; y and
                             dx, dW1, db1, dW2, db2 against the plain
                             versions and against a float64 oracle built
                             from the dumped masks
     * deberta_attn_bwd      DeBERTa attention backward at B 8, T 256, D 384,
                             6 heads, a padded tail and a row with no valid
                             key: dq, dk, dv, dPK, dPQ, fp32 and bf16
     * swin_attn_train_fwd,  Swinv2 window attention for fine-tuning,
       swin_attn_train_bwd   forward and backward (dq, dk, dv, dbias) at the
                             four Swinv2-base stage geometries, B 8, fp32
                             and bf16
  4. serve            full-width serving with the BERT-class text encoder
                      (512 tokens) and the ViT, ModelConfig(fused_attn=True),
                      bf16, batch 16: a ServingEngine answers requests from
                      several threads; 56 flash launches per batch
  5. serve_reference  the same with the reference's encoders,
                      load_or_init_frozen(reference_families=True):
                      DeBERTa-v3-xsmall and Swinv2-base; per batch exactly
                      24 / 48 / 106 / 8 launches of the DeBERTa, Swin, LayerNorm
                      and flash kernels
  In both serve phases image requests must keep their image paths,
  probabilities must be finite and sum to 1, and one fp32 batch through the
  kernel path must agree with the explicit path.
  6. train            python -m mmd_tpu_torch.train's main path (build, then
                      run_training) at full width, batch 256, float32,
                      fused_attn, dropout 0.1, on synthetic learnable batches:
                      8 steps and one validation pass; every loss finite,
                      exactly 8 / 8 / 32 launches of the flash forward,
                      backward and dropout kernels a step (and 8 flash
                      forwards a validation batch), params moved,
                      metrics.jsonl and checkpoints written; wall time a
                      step and peak device memory
  7. train_bf16       the same with the default compute dtype, bfloat16:
                      exactly 6 / 6 / 8 / 8 / 8 launches of the fused MLP
                      forward and backward, the flash forward and backward
                      and the dropout kernel a step, none of the mask oracle
  8. train_parity     one fp32 step at batch 16 and full width, dropout on,
                      one seed, through fused_attn=True and fused_attn=False:
                      loss within 1e-5 relative, every grad leaf within 1e-4
                      of its largest |value|
  9. train_parity_bf16  one bf16 step at batch 16 and full width, dropout
                      on, one seed, through the fused and the unfused MLP:
                      loss within 1e-3 relative, the gradient within 1e-1
                      in L2 norm; the fused step with a wrong seed must
                      fail the same check
 10. finetune_reference  8 steps of end-to-end fine-tuning of the reference
                      encoders (Trainer(finetune=True) on
                      load_or_init_frozen(reference_families=True):
                      DeBERTa-v3-xsmall and Swinv2-base with fused_train,
                      bf16) with the default fusion model, batch 8, 256
                      tokens, raw batches: finite losses, exactly 24 / 24 /
                      48 / 48 launches a step of the DeBERTa forward and
                      backward and the Swin fine-tuning forward and
                      backward, the fusion model's kernels, none of the
                      serving Swin kernel or the LayerNorm; wall time a
                      step and peak device memory
 11. finetune_parity  one fp32 step of the same at batch 2, dropout 0,
                      through the kernels and through both encoders'
                      explicit paths: loss within 1e-4 relative, each
                      tree's (fusion, text, vit) gradient within 1e-3 in
                      L2 norm
 12. train_raw        a synthetic Factify tree (64 train rows, 256 px) ->
                      preprocess_csv -> python -m mmd_tpu_torch.train's
                      main on the raw path, 2 epochs at batch 8, default
                      encoder families: frozen, then --finetune_encoders;
                      finite losses, metrics.jsonl, the launches a step
The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record, with each kernel's launches in the counted runs of
the serve, serve_reference, train, train_bf16, finetune_reference and
train_raw phases.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# -- tolerances ----------------------------------------------------------------
# kernel vs fp32 plain version on the same (bf16-rounded) inputs:
#   fp32: summation order, exp2f and rsqrtf only
#   bf16: the output is rounded to bf16 once -- the flash phase keeps its
#   fixed 2e-2 (|o| up to ~3); the other kernels allow one bf16 step at the
#   largest |output| of the call
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3          # fp32 statistics in both
# fp32 serving, kernel path vs explicit path, on class probabilities
PROB_TOL = 1e-3

# the card's published peaks (H100 SXM data sheet) for the bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12       # CUDA cores: fp32 has no tensor-core rate
                              # without TF32, which the port keeps off

BATCH = 16
TEXT = dict(name="text", t=512, s=512, d=384, h=6, masked=True)
VIT = dict(name="vit", t=64, s=64, d=1024, h=16, masked=False)
FUSION = [dict(name=f"fusion_{t}x{s}", t=t, s=s, d=256, h=8, masked=False)
          for t in (512, 64) for s in (512, 64)]
# flash launches per served batch of 16, by geometry: 12 layers x (claim,
# evidence) for each encoder; the fusion model's 2 self, 2 second-self and
# 4 evidence attentions at (text 512, image 64) lengths
PER_BATCH = {"text": 24, "vit": 24, "fusion_512x512": 3, "fusion_64x64": 3,
             "fusion_512x64": 1, "fusion_64x512": 1}
LAUNCHES_PER_BATCH = sum(PER_BATCH.values())          # 56
FUSION_PER_BATCH = 8

# Swinv2-base LayerNorms per served batch (two forwards): (rows, C,
# shortcut) -> launches. rows = 16 images x tokens of the stage.
LN_GEOMS = {(65536, 128, False): 2,     # patch-embedding norm
            (65536, 128, True): 8,      # stage 0: 2 blocks x 2 norms
            (16384, 256, True): 8,      # stage 1
            (4096, 512, True): 72,      # stage 2: 18 blocks
            (1024, 1024, True): 8,      # stage 3
            (16384, 256, False): 2,     # patch merges
            (4096, 512, False): 2,
            (1024, 1024, False): 4}     # last merge + final norm
# Swinv2-base window attentions per served batch: (nW, C, heads, bias
# windows) -> launches; unshifted blocks share one bias over the windows
SWIN_GEOMS = {(64, 128, 4, 1): 2, (64, 128, 4, 64): 2,
              (16, 256, 8, 1): 2, (16, 256, 8, 16): 2,
              (4, 512, 16, 1): 18, (4, 512, 16, 4): 18,
              (1, 1024, 32, 1): 4}
DEBERTA = dict(t=512, d=384, h=6, per_batch=24)
REFERENCE_PER_BATCH = {"deberta_attn_fwd": DEBERTA["per_batch"],
                       "swin_window_attn": sum(SWIN_GEOMS.values()),
                       "layernorm": sum(LN_GEOMS.values()),
                       "flash_attn_fwd": FUSION_PER_BATCH}

# The fusion train step at batch 256, fp32, dropout 0.1.
TRAIN_B = 256
DROPOUT_RATE = 0.1
# Elementwise dropouts a step, (N, D) -> launches, forward and backward:
# text-query MLPs (claim second self-attention, text-text, text-image) at
# N = 256 x 512 and image-query MLPs at N = 256 x 64, each dropping after
# GELU (4 x 256 wide) and after fc2 (256 wide); the four classifier heads
# drop their (256, 64) hidden layer.
DROPOUT_GEOMS = {(131072, 1024): 6, (131072, 256): 6, (16384, 1024): 6,
                 (16384, 256): 6, (256, 64): 8}
# Flash forwards (and backwards) a step, by (T, S): two self-attentions
# and two second self-attentions, then the evidence paths text-text,
# text-image, image-text, image-image.
TRAIN_PER_STEP = {"fusion_512x512": 3, "fusion_64x64": 3,
                  "fusion_512x64": 1, "fusion_64x512": 1}
PER_STEP = {"flash_attn_fwd": sum(TRAIN_PER_STEP.values()),
            "flash_attn_bwd": sum(TRAIN_PER_STEP.values()),
            "dropout": sum(DROPOUT_GEOMS.values())}          # 8 / 8 / 32
TRAIN_STEPS = 8
# The bf16 train step: the six MLPs run the fused kernels (#3 forward, #4
# backward), so only the heads' (256, 64) dropouts stay elementwise.
# (N rows, D, F) -> MLP calls a step: the three text-query MLPs and the
# three image-query MLPs.
MLP_GEOMS = {(131072, 256, 1024): 3, (16384, 256, 1024): 3}
MLP_PER_STEP = sum(MLP_GEOMS.values())                     # 6
PER_STEP_BF16 = {"flash_attn_fwd": PER_STEP["flash_attn_fwd"],
                 "flash_attn_bwd": PER_STEP["flash_attn_bwd"],
                 "dropout": DROPOUT_GEOMS[(256, 64)],
                 "mlp_fwd": MLP_PER_STEP, "mlp_bwd": MLP_PER_STEP}   # 8/8/8/6/6
# kernels #3 and #4 against their plain versions on the same bf16 inputs,
# relative to each output's largest |value|: one bf16 rounding of the
# output, and of h, dyb and dab inside, after fp32 sums in another order
MLP_TOL = 2.0 ** -7
# against the float64 oracle built from #12's masks, which rounds nothing:
# the kernels' bf16 roundings of h, dyb, dab and the outputs (the bound
# benchmarks/validate_mlp_tpu.py holds the TPU kernels to); a wrong mask
# flips ~10% of the hidden entries with an O(1) effect
ORACLE_TOL = 2e-2
# train_parity: loss relative, grads relative to each leaf's largest |g|;
# a leaf whose true gradient is zero (the key projections' biases: softmax
# ignores a shift shared by all keys) holds fp32 noise, so no leaf is held
# to less than 1e-3 of the model's largest gradient
PARITY_LOSS_RTOL = 1e-5
PARITY_GRAD_RTOL = 1e-4
PARITY_FLOOR = 1e-3
# train_parity_bf16, fused vs unfused MLP: the same masks, but the unfused
# path rounds to bf16 after fc1, after its bias, after GELU and after each
# dropout where the kernels round h and y once, so the two steps differ by
# bf16 roundings (2^-8 each) carried through the step. The loss averages
# them over 16 samples and 4 paths: within 1e-3 relative. The gradient as
# one vector (all leaves) within 1e-1 in L2 norm: the classifier heads
# carry most of its norm, and at batch 16 their gradients are sums of few
# terms, each moved by the roundings of the logits; a single leaf is no
# yardstick in bf16 (a head's can move by a fifth of itself). A wrong
# mask moves the gradient by about half its norm.
PARITY_BF16_LOSS_RTOL = 1e-3
PARITY_BF16_GRAD_RTOL = 1e-1

# The reference fine-tuning step: batch 8, 256 tokens (the JAX package's
# fine-tune benchmarks), DeBERTa-v3-xsmall (12 layers, D 384, 6 heads) on
# the claim and the document, Swinv2-base on both images.
FT_STEPS = 8
FT_DEBERTA = dict(b=8, t=256, d=384, h=6, per_step=24)
# Swinv2-base window attentions a fine-tuning step: (nW, C, heads) -> the
# blocks of the stage x 2 images
FT_SWIN_GEOMS = {(64, 128, 4): 4, (16, 256, 8): 4, (4, 512, 16): 36,
                 (1, 1024, 32): 4}
FT_PER_STEP = {"deberta_attn_fwd": 24, "deberta_attn_bwd": 24,
               "swin_attn_train_fwd": 48, "swin_attn_train_bwd": 48,
               "flash_attn_fwd": 8, "flash_attn_bwd": 8, "mlp_fwd": 6,
               "mlp_bwd": 6, "dropout": 8}
# finetune_parity, fp32 at batch 2, kernels vs explicit paths, set before
# the first run: the two differ by the order of fp32 sums through 12
# DeBERTa layers and 24 Swin blocks, forward and backward (and the Swin
# kernels' exp2 of log2-domain scores against exp of natural ones); a
# wrong gradient in #8, #9, #10 or #11 moves its tree by O(1)
FT_PARITY_LOSS_RTOL = 1e-4
FT_PARITY_GRAD_RTOL = 1e-3
# train_raw: the default families' launches a step, claim and document
# through 12 text layers and 12 ViT layers, then the fusion model's
RAW_FROZEN_PER_STEP = {"flash_attn_fwd": 56, "flash_attn_bwd": 8,
                       "mlp_fwd": 6, "mlp_bwd": 6, "dropout": 8}
RAW_FINETUNE_PER_STEP = {**RAW_FROZEN_PER_STEP, "flash_attn_bwd": 56}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return {"card": card, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def _kernels():
    """kernel name -> (op module, its loader, its launch counter)."""
    from mmd_tpu_torch.ops import attention, deberta_attention, dropout, ln, \
        mlp, swin_attention
    return {"flash_attn_fwd": (attention, "load_kernel", "launches"),
            "layernorm": (ln, "load_kernel", "launches"),
            "swin_window_attn": (swin_attention, "load_kernel", "launches"),
            "deberta_attn_fwd": (deberta_attention, "load_kernel",
                                 "launches"),
            "dropout": (dropout, "load_kernel", "launches"),
            "flash_attn_bwd": (attention, "load_bwd_kernel", "bwd_launches"),
            "mlp_fwd": (mlp, "load_kernel", "launches"),
            "mlp_bwd": (mlp, "load_bwd_kernel", "bwd_launches"),
            "mlp_masks": (mlp, "load_masks_kernel", "mask_launches"),
            "deberta_attn_bwd": (deberta_attention, "load_bwd_kernel",
                                 "bwd_launches"),
            "swin_attn_train_fwd": (swin_attention, "load_train_kernel",
                                    "train_launches"),
            "swin_attn_train_bwd": (swin_attention, "load_train_bwd_kernel",
                                    "train_bwd_launches")}


def _reset_counts() -> None:
    for mod, _, counter in _kernels().values():
        setattr(mod, counter, 0)


def _counts() -> dict:
    return {name: getattr(mod, counter)
            for name, (mod, _, counter) in _kernels().items()}


def phase_build() -> None:
    from mmd_tpu_torch.ops import cuda_build
    kernels = _kernels()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as ex:     # one nvcc per source
        list(ex.map(lambda k: getattr(k[0], k[1])(), kernels.values()))
    for name in kernels:
        secs = cuda_build.build_seconds.get(name)
        print(f"build: {name} nvcc "
              f"{'%.3f s' % secs if secs is not None else 'skipped: built'}",
              flush=True)
    print(f"build: all {len(kernels)} loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float,
              peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def _bf16_step(ref: torch.Tensor) -> float:
    top = ref.abs().max().item()
    return 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def _record(name, source, replaces, per_batch_rows, errs, note=None):
    """Sum per-geometry times over one served batch's launches."""
    ms = sum(n * r["ms"] for n, r in per_batch_rows)
    plain = sum(n * r["plain_ms"] for n, r in per_batch_rows)
    bound = sum(n * r["bound_ms"] for n, r in per_batch_rows)
    libs = [r["library_ms"] for _, r in per_batch_rows]
    # the resource behind most of the summed bound
    share = {"bytes": 0.0, "operations": 0.0}
    for n, r in per_batch_rows:
        share[r["bound_by"]] += n * r["bound_ms"]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain, "bound_ms": bound,
            "bound_by": max(share, key=share.get),
            "library_ms": None if None in libs else sum(
                n * r["library_ms"] for n, r in per_batch_rows),
            "library_note": note}


def _print_time(kernel, geom, row, card):
    lib = (f", library {row['library_ms']:.4f} ms"
           if row["library_ms"] is not None else "")
    print(f"time   {kernel} {geom}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms{lib}, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})  [{card}]", flush=True)


def phase_flash(card: str) -> dict:
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    errs, rows = [], []
    for g in [TEXT, VIT, *FUSION]:
        b, t, s, d, h = BATCH, g["t"], g["s"], g["d"], g["h"]
        q32 = torch.randn(b, t, d, device=dev, generator=gen)
        k32 = torch.randn(b, s, d, device=dev, generator=gen)
        v32 = torch.randn(b, s, d, device=dev, generator=gen)
        mask = lib_mask = None
        if g["masked"]:
            # valid lengths from 1 to S, and a last row with no valid key
            lengths = torch.linspace(1, s, b - 1, device=dev).round().long()
            mask = (torch.arange(s, device=dev)[None] < lengths[:, None])
            # SDPA gives NaN on a row with no valid key: time it on the
            # same lengths with the last row given one valid key
            lib_mask = torch.cat([mask, torch.arange(s, device=dev)[None] < 1])
            mask = torch.cat([mask, torch.zeros(1, s, dtype=torch.bool,
                                                device=dev)]).to(torch.int32)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            o, lse = A.flash_attention(q, k, v, h, mask)
            torch.cuda.synchronize()
            o_ref, lse_ref = A.flash_attention_plain(
                q.float(), k.float(), v.float(), h, mask)
            err = (o.float() - o_ref).abs().max().item()
            fin = torch.isfinite(lse_ref)
            lse_err = (lse[fin] - lse_ref[fin]).abs().max().item()
            ok = (err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                  and torch.equal(torch.isfinite(lse), fin))
            if mask is not None:
                ok = ok and bool((o[-1] == 0).all()) and bool(
                    torch.isneginf(lse[-1]).all())
            print(f"kernel flash_attn_fwd {g['name']:>14} {str(dtype):>14}: "
                  f"max_abs_err {err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse "
                  f"err {lse_err:.3e}"
                  f"{', masked row zeros' if mask is not None else ''}"
                  f" -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"flash kernel disagrees with its plain version at "
                     f"{g['name']} {dtype}")
            errs.append(err)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                      for x in (q, k, v))
        am = None if lib_mask is None else lib_mask[:, None, None, :]
        nbytes = 2 * (2 * b * t * d + 2 * b * s * d) + 4 * b * h * t + (
            b * s if mask is not None else 0)
        row = {"ms": _time_ms(lambda: A.flash_attention(q, k, v, h, mask)),
               "plain_ms": _time_ms(
                   lambda: A.flash_attention_plain(q, k, v, h, mask)),
               "library_ms": _time_ms(lambda: sdpa(qh, kh, vh, attn_mask=am))}
        row["bound_ms"], row["bound_by"] = _bound_ms(nbytes,
                                                     4 * b * t * s * d)
        _print_time("flash_attn_fwd", f"{g['name']} bf16 B={b} T={t} S={s} "
                    f"D={d} H={h}", row, card)
        rows.append((PER_BATCH[g["name"]], row))
    rec = _record("flash_attn_fwd", "mmd_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                  "mmd_tpu/ops/attention.py:430", rows, errs,
                  "torch.nn.functional.scaled_dot_product_attention with a "
                  "boolean key mask, (B, H, T, dh) views; the text geometry's "
                  "row with no valid key given one valid key (SDPA gives NaN "
                  "there)")
    print(f"kernel flash_attn_fwd per served batch of {BATCH} "
          f"({LAUNCHES_PER_BATCH} launches, serve phase): kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
          f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def phase_layernorm(card: str) -> dict:
    from mmd_tpu_torch.ops import ln as LN
    layer_norm = torch.nn.functional.layer_norm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    errs, rows = [], []
    for (r, c, res), n in LN_GEOMS.items():
        p = torch.nn.LayerNorm(c).to(dev)
        with torch.no_grad():
            p.weight.normal_(generator=gen)
            p.bias.normal_(generator=gen)
        y32 = torch.randn(r, c, device=dev, generator=gen)
        x32 = torch.randn(r, c, device=dev, generator=gen) if res else None
        with torch.no_grad():
            for dtype in (torch.bfloat16, torch.float32):
                y = y32.to(dtype)
                x = None if x32 is None else x32.to(dtype)
                out = LN.fused_layernorm(p, y, 1e-5, x)
                torch.cuda.synchronize()
                ref = LN.fused_layernorm_plain(p, y.float(), 1e-5,
                                               None if x is None else x.float())
                err = (out.float() - ref).abs().max().item()
                tol = (KERNEL_TOL[dtype] if dtype == torch.float32
                       else _bf16_step(ref))
                print(f"kernel layernorm ({r}, {c}) shortcut={res} "
                      f"{str(dtype):>14}: max_abs_err {err:.3e} (tol "
                      f"{tol:.3e}) -> {'ok' if err <= tol else 'FAIL'}",
                      flush=True)
                if not err <= tol:
                    fail(f"layernorm kernel disagrees with its plain version "
                         f"at ({r}, {c}) {dtype}")
                errs.append(err)
            y = y32.to(torch.bfloat16)
            x = None if x32 is None else x32.to(torch.bfloat16)
            wb, bb = p.weight.to(torch.bfloat16), p.bias.to(torch.bfloat16)
            row = {"ms": _time_ms(lambda: LN.fused_layernorm(p, y, 1e-5, x)),
                   "plain_ms": _time_ms(
                       lambda: LN.fused_layernorm_plain(p, y, 1e-5, x)),
                   # the shortcut's add is not part of F.layer_norm's time
                   "library_ms": _time_ms(
                       lambda: layer_norm(y, (c,), wb, bb, 1e-5))}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            2 * r * c * (3 if res else 2) + 8 * c, 8 * r * c)
        _print_time("layernorm", f"({r}, {c}) shortcut={res} bf16", row,
                    card)
        rows.append((n, row))
    rec = _record("layernorm", "mmd_tpu_torch/ops/csrc/layernorm.cu",
                  "mmd_tpu/ops/ln.py:106", rows, errs,
                  "torch.nn.functional.layer_norm on the same bf16 input "
                  "(weights cast to bf16); the shortcut's add is excluded")
    print(f"kernel layernorm per served batch ({sum(LN_GEOMS.values())} "
          f"launches): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, F.layer_norm {rec['library_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def phase_swin(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, rows = [], []
    n = 64
    for (nw, c, h, nwb), count in SWIN_GEOMS.items():
        q32, k32, v32 = (torch.randn(nw, BATCH, n, c, device=dev,
                                     generator=gen) for _ in range(3))
        # position bias in (0, 16) plus, for shifted windows, twice a
        # 0 / -100 region mask
        bias = 16 * torch.rand(1, h, n, n, device=dev, generator=gen)
        if nwb > 1:
            region = torch.rand(nwb, 1, n, n, device=dev, generator=gen) < 0.3
            bias = bias - 200.0 * region
        bias = bias.expand(nwb, h, n, n).contiguous()
        scale = torch.exp(torch.clamp(
            torch.rand(h, device=dev, generator=gen) * 5, max=math.log(100)))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            o = SA.swin_window_attention_infer(q, k, v, bias, scale, h)
            torch.cuda.synchronize()
            ref = SA.swin_window_attention_infer_plain(
                q.float(), k.float(), v.float(), bias, scale, h)
            err = (o.float() - ref).abs().max().item()
            tol = (KERNEL_TOL[dtype] if dtype == torch.float32
                   else _bf16_step(ref))
            print(f"kernel swin_window_attn nW={nw} C={c} h={h} "
                  f"bias_windows={nwb} {str(dtype):>14}: max_abs_err "
                  f"{err:.3e} (tol {tol:.3e}) -> "
                  f"{'ok' if err <= tol else 'FAIL'}", flush=True)
            if not err <= tol:
                fail(f"swin kernel disagrees with its plain version at nW={nw}"
                     f" C={c} {dtype}")
            errs.append(err)
        q, k, v = (x.to(torch.bfloat16) for x in (q32, k32, v32))
        row = {"ms": _time_ms(
            lambda: SA.swin_window_attention_infer(q, k, v, bias, scale, h)),
               "plain_ms": _time_ms(
            lambda: SA.swin_window_attention_infer_plain(q, k, v, bias, scale,
                                                         h)),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            2 * 4 * nw * BATCH * n * c + 4 * nwb * h * n * n + 4 * h,
            4 * nw * BATCH * n * n * c)
        _print_time("swin_window_attn", f"nW={nw} B={BATCH} n={n} C={c} h={h} "
                    f"bias_windows={nwb} bf16", row, card)
        rows.append((count, row))
    rec = _record("swin_window_attn",
                  "mmd_tpu_torch/ops/csrc/swin_window_attn.cu",
                  "mmd_tpu/ops/swin_attention.py:151", rows, errs,
                  "no single PyTorch call computes it: the per-head L2 "
                  "normalization of q and k is part of the function")
    print(f"kernel swin_window_attn per served batch "
          f"({sum(SWIN_GEOMS.values())} launches): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def phase_deberta(card: str) -> dict:
    from mmd_tpu_torch.ops import deberta_attention as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    b, t, d, h = BATCH, DEBERTA["t"], DEBERTA["d"], DEBERTA["h"]
    q32, k32, v32 = (torch.randn(b, t, d, device=dev, generator=gen)
                     for _ in range(3))
    pk32, pq32 = (torch.randn(2 * t, d, device=dev, generator=gen)
                  for _ in range(2))
    # valid lengths from 1 to T, and a last row with no valid key
    lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
    mask = torch.cat([torch.arange(t, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, t, dtype=torch.bool, device=dev)]).int()
    scale = 1.0 / math.sqrt(3.0 * d // h)
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        args = [x.to(dtype) for x in (q32, k32, v32, pk32, pq32)]
        o = DA.deberta_attention(*args, mask, h, scale)
        torch.cuda.synchronize()
        ref = DA.deberta_attention_plain(*[x.float() for x in args], mask, h,
                                         scale)
        err = (o.float() - ref).abs().max().item()
        tol = (KERNEL_TOL[dtype] if dtype == torch.float32
               else _bf16_step(ref))
        uniform = args[2][-1].float().mean(0).expand(t, d)
        uerr = (o[-1].float() - uniform).abs().max().item()
        ok = err <= tol and uerr <= tol
        print(f"kernel deberta_attn_fwd B={b} T={t} D={d} H={h} "
              f"{str(dtype):>14}: max_abs_err {err:.3e} (tol {tol:.3e}), "
              f"row with no valid key vs uniform mean of V {uerr:.3e} -> "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"deberta kernel disagrees with its plain version at {dtype}")
        errs.append(max(err, uerr))
    args = [x.to(torch.bfloat16) for x in (q32, k32, v32, pk32, pq32)]
    row = {"ms": _time_ms(lambda: DA.deberta_attention(*args, mask, h, scale)),
           "plain_ms": _time_ms(
               lambda: DA.deberta_attention_plain(*args, mask, h, scale)),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = _bound_ms(
        2 * (4 * b * t * d + 2 * 2 * t * d) + b * t, 8 * b * t * t * d)
    _print_time("deberta_attn_fwd", f"B={b} T={t} D={d} H={h} bf16", row,
                card)
    rec = _record("deberta_attn_fwd",
                  "mmd_tpu_torch/ops/csrc/deberta_attn_fwd.cu",
                  "mmd_tpu/models/deberta.py:293",
                  [(DEBERTA["per_batch"], row)], errs,
                  "no single PyTorch call computes it: the c2p and p2c "
                  "terms gather from relative-position tables per (t, s)")
    print(f"kernel deberta_attn_fwd per served batch ({DEBERTA['per_batch']} "
          f"launches): kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
          f"ms, bound {rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def phase_dropout(card: str) -> dict:
    """Elementwise dropout at every dropout geometry of the train step."""
    from mmd_tpu_torch.ops import dropout as D
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    errs, rows = [], []
    for (n, d), count in DROPOUT_GEOMS.items():
        x32 = torch.randn(n, d, device=dev, generator=gen)
        seed = 0x5EED0000 + n + d
        for dtype, bits in ((torch.bfloat16, torch.int16),
                            (torch.float32, torch.int32)):
            x = x32.to(dtype)
            y = D.dropout(x, DROPOUT_RATE, seed)
            torch.cuda.synchronize()
            ref = D.dropout_plain(x, DROPOUT_RATE, seed)
            same = torch.equal(y.view(bits), ref.view(bits))
            err = (y.float() - ref.float()).abs().max().item()
            kept = (D.keep_scale(seed, (n, d), DROPOUT_RATE, dev) != 0
                    ).double().mean().item()
            sigma = math.sqrt(DROPOUT_RATE * (1 - DROPOUT_RATE) / (n * d))
            ok = same and abs(kept - (1 - DROPOUT_RATE)) <= 4 * sigma
            print(f"kernel dropout ({n}, {d}) {str(dtype):>14}: "
                  f"bit-identical {same}, max_abs_err {err:.3e}, kept "
                  f"{kept:.6f} (1 - rate {1 - DROPOUT_RATE}, 4 sigma "
                  f"{4 * sigma:.2e}) -> {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                fail(f"dropout kernel disagrees with its plain version at "
                     f"({n}, {d}) {dtype}")
            errs.append(err)
        x = x32                                # the train step's dtype
        row = {"ms": _time_ms(lambda: D.dropout(x, DROPOUT_RATE, 1)),
               "plain_ms": _time_ms(
                   lambda: D.dropout_plain(x, DROPOUT_RATE, 1), iters=3,
                   warmup=1),
               "library_ms": _time_ms(lambda: torch.nn.functional.dropout(
                   x, DROPOUT_RATE, training=True))}
        row["bound_ms"], row["bound_by"] = _bound_ms(2 * 4 * n * d, n * d,
                                                     PEAK_FP32_FLOPS)
        _print_time("dropout", f"({n}, {d}) fp32", row, card)
        rows.append((count, row))
    rec = _record("dropout", "mmd_tpu_torch/ops/csrc/dropout.cu",
                  "mmd_tpu/ops/dropout.py:59", rows, errs,
                  "torch.nn.functional.dropout(training=True) on the same "
                  "fp32 input (its own generator and mask)")
    print(f"kernel dropout per train step ({sum(DROPOUT_GEOMS.values())} "
          f"launches, fp32): kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, F.dropout {rec['library_ms']:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def _train_geoms():
    for g in FUSION:
        yield dict(g, b=TRAIN_B, per_step=TRAIN_PER_STEP[g["name"]])


def phase_flash_train(card: str) -> dict:
    """The flash forward with attention dropout at the train step's
    geometries, batch 256; rate 0 at the same inputs too."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    errs, rows = [], []
    for g in _train_geoms():
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32 = (torch.randn(b, n, d, device=dev, generator=gen)
                         for n in (t, s, s))
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            for rate in (DROPOUT_RATE, 0.0):
                o, lse = A.flash_attention(q, k, v, h, None, rate, 77)
                torch.cuda.synchronize()
                o_ref, lse_ref = A.flash_attention_plain(
                    q.float(), k.float(), v.float(), h, None, rate, 77)
                err = (o.float() - o_ref).abs().max().item()
                lse_err = (lse - lse_ref).abs().max().item()
                ok = err <= KERNEL_TOL[dtype] and lse_err <= LSE_TOL
                print(f"kernel flash_attn_fwd {g['name']:>14} B={b} "
                      f"{str(dtype):>14} rate {rate}: max_abs_err "
                      f"{err:.3e} (tol {KERNEL_TOL[dtype]:.0e}), lse err "
                      f"{lse_err:.3e} -> {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    fail(f"flash kernel with dropout {rate} disagrees with "
                         f"its plain version at {g['name']} {dtype}")
                errs.append(err)
                del o, lse, o_ref, lse_ref
        q, k, v = q32, k32, v32                # the train step's dtype
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2)
                      for x in (q, k, v))
        row = {"ms": _time_ms(lambda: A.flash_attention(
                   q, k, v, h, None, DROPOUT_RATE, 1), iters=10),
               "plain_ms": _time_ms(lambda: A.flash_attention_plain(
                   q, k, v, h, None, DROPOUT_RATE, 1), iters=2, warmup=1),
               "library_ms": _time_ms(lambda: sdpa(
                   qh, kh, vh, dropout_p=DROPOUT_RATE), iters=10)}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            4 * (2 * b * t * d + 2 * b * s * d) + 4 * b * h * t,
            4 * b * t * s * d, PEAK_FP32_FLOPS)
        _print_time("flash_attn_fwd", f"{g['name']} fp32 dropout "
                    f"{DROPOUT_RATE} B={b} T={t} S={s} D={d} H={h}", row,
                    card)
        rows.append((g["per_step"], row))
        torch.cuda.empty_cache()
    rec = _record("flash_attn_fwd", "", "", rows, errs)
    step = {k: rec[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by", "max_abs_err")}
    step["launches_per_step"] = PER_STEP["flash_attn_fwd"]
    step["library_note"] = ("torch.nn.functional.scaled_dot_product_"
                            "attention(dropout_p=0.1), fp32, (B, H, T, dh) "
                            "views")
    print(f"kernel flash_attn_fwd per train step "
          f"({PER_STEP['flash_attn_fwd']} launches, fp32, dropout "
          f"{DROPOUT_RATE}): kernel {step['ms']:.4f} ms, plain "
          f"{step['plain_ms']:.4f} ms, SDPA {step['library_ms']:.4f} ms, "
          f"bound {step['bound_ms']:.4f} ms  [{card}]", flush=True)
    return step


def _bwd_tol(dtype) -> float:
    """Relative to the largest |reference gradient|: fp32 summation order;
    bf16 one rounding of the output."""
    return 1e-4 if dtype == torch.float32 else 2.0 ** -7


def phase_flash_bwd(card: str) -> dict:
    """dq, dk, dv against flash_attention_bwd_plain: the train step's
    geometries at batch 256 with and without dropout, and the masked text
    geometry (batch 16, a row with no valid key) at rate 0."""
    from mmd_tpu_torch.ops import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    errs, rows = [], []
    text = dict(TEXT, b=BATCH, per_step=0)
    for g in [*_train_geoms(), text]:
        b, t, s, d, h = g["b"], g["t"], g["s"], g["d"], g["h"]
        q32, k32, v32, do32 = (torch.randn(b, n, d, device=dev,
                                           generator=gen)
                               for n in (t, s, s, t))
        mask = None
        if g["masked"]:
            lengths = torch.linspace(1, s, b - 1, device=dev).round().long()
            mask = torch.cat([
                torch.arange(s, device=dev)[None] < lengths[:, None],
                torch.zeros(1, s, dtype=torch.bool, device=dev)]).int()
        rates = (0.0,) if g["masked"] else (DROPOUT_RATE, 0.0)
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
            for rate in rates:
                o, lse = A.flash_attention(q, k, v, h, mask, rate, 88)
                got = A.flash_attention_bwd(q, k, v, o, lse, do, h, mask,
                                            rate, 88)
                torch.cuda.synchronize()
                want = A.flash_attention_bwd_plain(
                    q.float(), k.float(), v.float(), o.float(), lse,
                    do.float(), h, mask, rate, 88)
                tol = _bwd_tol(dtype)
                abs_errs = [(x.float() - w).abs().max().item()
                            for x, w in zip(got, want)]
                rel = [e / max(w.abs().max().item(), 1e-30)
                       for e, w in zip(abs_errs, want)]
                ok = max(rel) <= tol
                if mask is not None:
                    ok = ok and bool((got[0][-1] == 0).all())
                print(f"kernel flash_attn_bwd {g['name']:>14} B={b} "
                      f"{str(dtype):>14} rate {rate}: max_abs_err dq/dk/dv "
                      f"{abs_errs[0]:.3e}/{abs_errs[1]:.3e}/"
                      f"{abs_errs[2]:.3e}, relative {max(rel):.3e} (tol "
                      f"{tol:.1e})"
                      f"{', row with no valid key dq = 0' if mask is not None else ''}"
                      f" -> {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    fail(f"flash backward disagrees with its plain version "
                         f"at {g['name']} {dtype} rate {rate}")
                errs.append(max(abs_errs))
                del o, lse, got, want
        if not g["per_step"]:
            continue
        q, k, v, do = q32, k32, v32, do32      # the train step's dtype
        o, lse = A.flash_attention(q, k, v, h, None, DROPOUT_RATE, 1)
        qh, kh, vh = (x.view(b, -1, h, d // h).transpose(1, 2).detach()
                      .requires_grad_() for x in (q, k, v))
        out = sdpa(qh, kh, vh)
        gout = torch.randn_like(out)
        row = {"ms": _time_ms(lambda: A.flash_attention_bwd(
                   q, k, v, o, lse, do, h, None, DROPOUT_RATE, 1), iters=5),
               "plain_ms": _time_ms(lambda: A.flash_attention_bwd_plain(
                   q, k, v, o, lse, do, h, None, DROPOUT_RATE, 1), iters=2,
                   warmup=1),
               "library_ms": _time_ms(lambda: torch.autograd.grad(
                   out, (qh, kh, vh), gout, retain_graph=True), iters=5)}
        row["bound_ms"], row["bound_by"] = _bound_ms(
            4 * (4 * b * t * d + 4 * b * s * d) + 4 * b * h * t,
            10 * b * t * s * d, PEAK_FP32_FLOPS)
        _print_time("flash_attn_bwd", f"{g['name']} fp32 dropout "
                    f"{DROPOUT_RATE} B={b} T={t} S={s} D={d} H={h}", row,
                    card)
        rows.append((g["per_step"], row))
        del o, lse, out, gout, qh, kh, vh
        torch.cuda.empty_cache()
    rec = _record("flash_attn_bwd", "mmd_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                  "mmd_tpu/ops/attention.py:471", rows, errs,
                  "the backward of torch.nn.functional.scaled_dot_product_"
                  "attention at rate 0, fp32 (forward excluded)")
    print(f"kernel flash_attn_bwd per train step "
          f"({PER_STEP['flash_attn_bwd']} launches, fp32, dropout "
          f"{DROPOUT_RATE}): kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, SDPA backward {rec['library_ms']:.4f} "
          f"ms, bound {rec['bound_ms']:.4f} ms  [{card}]", flush=True)
    return rec


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max-abs error relative to the largest |want|."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp_min(1e-30)).item()


def _mlp_oracle(x, w1, b1, w2, b2, dy, m1, m2):
    """y and (dx, dw1, db1, dw2, db2) of the fused MLP in float64 from the
    dumped masks m1, m2, rounding nothing (benchmarks/validate_mlp_tpu.py,
    step 3)."""
    x, w1, b1, w2, b2, dy, m1, m2 = (t.double() for t in
                                     (x, w1, b1, w2, b2, dy, m1, m2))
    c, k = math.sqrt(2.0 / math.pi), 0.044715
    a = x @ w1 + b1
    t = torch.tanh(c * (a + k * a * a * a))
    h = 0.5 * a * (1.0 + t) * m1
    y = (h @ w2 + b2) * m2
    dy0 = dy * m2
    da = (dy0 @ w2.T) * m1 * (0.5 * (1.0 + t) + 0.5 * a * (1.0 - t * t) * c
                              * (1.0 + 3.0 * k * a * a))
    return y, (da @ w1.T, x.T @ da, da.sum(0), h.T @ dy0, dy0.sum(0))


def phase_mlp(card: str) -> dict:
    """Kernels #12, #3 and #4 at the bf16 train step's MLP geometries, rate
    0.1 and 0: the masks bit-identical to their plain version, the forward
    and the backward against their plain versions and against the float64
    oracle of the dumped masks; times per train step."""
    from mmd_tpu_torch.ops import dropout as D
    from mmd_tpu_torch.ops import mlp as M
    fn = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    names = ("mlp_fwd", "mlp_bwd", "mlp_masks")
    errs = {k: [] for k in names}
    rows = {k: [] for k in names}
    for (n, d, f), count in MLP_GEOMS.items():
        x = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        w1 = (torch.randn(d, f, device=dev, generator=gen)
              / math.sqrt(d)).bfloat16()
        b1 = 0.1 * torch.randn(f, device=dev, generator=gen)
        w2 = (torch.randn(f, d, device=dev, generator=gen)
              / math.sqrt(f)).bfloat16()
        b2 = 0.1 * torch.randn(d, device=dev, generator=gen)
        dy = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        for rate in (DROPOUT_RATE, 0.0):
            seeds = M.mask_seeds(rate, 0x5EED + n)
            m1, m2 = M.mlp_masks(n, d, f, seeds, rate, dev)
            torch.cuda.synchronize()
            p1, p2 = M.mlp_masks_plain(n, d, f, seeds, rate, dev)
            same = torch.equal(m1, p1) and torch.equal(m2, p2)
            del p1, p2
            kept = [(m != 0).double().mean().item() for m in (m1, m2)]
            sigma = [math.sqrt(rate * (1 - rate) / m.numel()) for m in (m1, m2)]
            kept_ok = all(abs(k - (1 - rate)) <= 4 * s
                          for k, s in zip(kept, sigma))
            y = M.fused_mlp_fwd(x, w1, b1, w2, b2, seeds, rate)
            got = M.fused_mlp_bwd(x, w1, b1, w2, dy, seeds, rate)
            torch.cuda.synchronize()
            want_y = M.fused_mlp_plain(x, w1, b1, w2, b2, seeds, rate)
            want = M.fused_mlp_bwd_plain(x, w1, b1, w2, dy, seeds, rate)
            rel = [_rel(y, want_y)] + [_rel(g, w) for g, w in zip(got, want)]
            fwd_abs = (y.float() - want_y).abs().max().item()
            bwd_abs = max((g.float() - w).abs().max().item()
                          for g, w in zip(got, want))
            del want_y, want
            y64, g64 = _mlp_oracle(x, w1, b1, w2, b2, dy, m1, m2)
            orc = [_rel(y, y64)] + [_rel(g, w) for g, w in zip(got, g64)]
            del y64, g64, m1, m2
            ok = (same and kept_ok and max(rel) <= MLP_TOL
                  and max(orc) <= ORACLE_TOL)
            print(f"kernel mlp N={n} D={d} F={f} bf16 rate {rate}: masks "
                  f"bit-identical {same}, kept {kept[0]:.6f} / {kept[1]:.6f} "
                  f"(4 sigma {4 * sigma[0]:.1e} / {4 * sigma[1]:.1e}); vs "
                  f"plain y/dx/dw1/db1/dw2/db2 relative "
                  f"{'/'.join('%.2e' % e for e in rel)} (tol {MLP_TOL:.1e}); "
                  f"vs float64 oracle of the masks "
                  f"{'/'.join('%.2e' % e for e in orc)} (tol "
                  f"{ORACLE_TOL:.0e}) -> {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"fused MLP kernels disagree at N={n} rate {rate}")
            errs["mlp_fwd"].append(fwd_abs)
            errs["mlp_bwd"].append(bwd_abs)
            errs["mlp_masks"].append(0.0)
            del y, got
        # times at the train step's rate; the composition is the unfused
        # bf16 MLP: two cuBLAS GEMMs with their bias, F.gelu and kernel #5
        seeds = M.mask_seeds(DROPOUT_RATE, 1)
        w1t, w2t, b1b, b2b = (w1.T.contiguous(), w2.T.contiguous(),
                              b1.bfloat16(), b2.bfloat16())

        def composition(x_, w1t_, b1b_, w2t_, b2b_):
            h = fn.gelu(fn.linear(x_, w1t_, b1b_), approximate="tanh")
            h = fn.linear(D.dropout(h, DROPOUT_RATE, seeds[0]), w2t_, b2b_)
            return D.dropout(h, DROPOUT_RATE, seeds[1])

        leaves = [t.detach().requires_grad_()
                  for t in (x, w1t, b1b, w2t, b2b)]
        out = composition(*leaves)
        fwd = {"ms": _time_ms(lambda: M.fused_mlp_fwd(
                   x, w1, b1, w2, b2, seeds, DROPOUT_RATE), iters=10),
               "plain_ms": _time_ms(lambda: M.fused_mlp_plain(
                   x, w1, b1, w2, b2, seeds, DROPOUT_RATE), iters=2,
                   warmup=1),
               "library_ms": _time_ms(lambda: composition(
                   x, w1t, b1b, w2t, b2b), iters=10)}
        fwd["bound_ms"], fwd["bound_by"] = _bound_ms(
            2 * 2 * n * d + 2 * 2 * d * f + 4 * (f + d), 4 * n * d * f)
        bwd = {"ms": _time_ms(lambda: M.fused_mlp_bwd(
                   x, w1, b1, w2, dy, seeds, DROPOUT_RATE), iters=5),
               "plain_ms": _time_ms(lambda: M.fused_mlp_bwd_plain(
                   x, w1, b1, w2, dy, seeds, DROPOUT_RATE), iters=2,
                   warmup=1),
               "library_ms": _time_ms(lambda: torch.autograd.grad(
                   out, leaves, dy, retain_graph=True), iters=5)}
        bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
            2 * 3 * n * d + 2 * 2 * d * f + 4 * f
            + 4 * (2 * d * f + f + d), 10 * n * d * f)
        masks = {"ms": _time_ms(lambda: M.mlp_masks(
                     n, d, f, seeds, DROPOUT_RATE, dev), iters=10),
                 "plain_ms": _time_ms(lambda: M.mlp_masks_plain(
                     n, d, f, seeds, DROPOUT_RATE, dev), iters=2, warmup=1),
                 "library_ms": None}
        masks["bound_ms"], masks["bound_by"] = _bound_ms(4 * n * (f + d), 0)
        for name, row in zip(names, (fwd, bwd, masks)):
            _print_time(name, f"N={n} D={d} F={f} bf16 dropout "
                        f"{DROPOUT_RATE}", row, card)
            rows[name].append((count if name != "mlp_masks" else 1, row))
        del x, w1, w2, dy, w1t, w2t, leaves, out
        torch.cuda.empty_cache()
    composition = ("not one call: the unfused bf16 composition -- F.linear "
                   "(cuBLAS, bias in its epilogue), F.gelu(approximate="
                   "'tanh'), kernel #5, F.linear, kernel #5")
    recs = {
        "mlp_fwd": _record("mlp_fwd", "mmd_tpu_torch/ops/csrc/mlp_fwd.cu",
                           "mmd_tpu/ops/mlp.py:158", rows["mlp_fwd"],
                           errs["mlp_fwd"], composition),
        "mlp_bwd": _record("mlp_bwd", "mmd_tpu_torch/ops/csrc/mlp_bwd.cu",
                           "mmd_tpu/ops/mlp.py:179", rows["mlp_bwd"],
                           errs["mlp_bwd"], "the backward of " + composition
                           + " (forward excluded)"),
        "mlp_masks": _record("mlp_masks",
                             "mmd_tpu_torch/ops/csrc/mlp_masks.cu",
                             "benchmarks/validate_mlp_tpu.py:53",
                             rows["mlp_masks"], errs["mlp_masks"],
                             "none: no PyTorch call draws these masks; "
                             "times are one dump at each geometry")}
    for name in ("mlp_fwd", "mlp_bwd"):
        r = recs[name]
        print(f"kernel {name} per bf16 train step ({MLP_PER_STEP} launches):"
              f" kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"unfused composition {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms  [{card}]", flush=True)
    return recs


def _rel_tol(dtype, ref: torch.Tensor) -> float:
    """A gradient's tolerance against its fp32 plain version on the same
    inputs: fp32 sums in another order, 1e-4 of its largest |value|; bf16
    outputs one rounding, a bf16 step at the largest |value|."""
    if dtype == torch.float32:
        return 1e-4 * ref.abs().max().item()
    return _bf16_step(ref)


def _check_grads(kernel, what, got, want, dtypes) -> float:
    """Each named output against its plain version; returns the worst
    absolute error, fails past a tolerance."""
    worst = 0.0
    for (name, a), w, dtype in zip(got.items(), want, dtypes):
        err = (a.float() - w).abs().max().item()
        tol = _rel_tol(dtype, w)
        print(f"kernel {kernel} {what} {name:>5}: max_abs_err {err:.3e} "
              f"(tol {tol:.3e}) -> {'ok' if err <= tol else 'FAIL'}",
              flush=True)
        if not err <= tol:
            fail(f"{kernel} {name} disagrees with its plain version, {what}")
        worst = max(worst, err)
    return worst


def phase_deberta_bwd(card: str) -> dict:
    from mmd_tpu_torch.ops import deberta_attention as DA
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d, h = (FT_DEBERTA[k] for k in "btdh")
    q32, k32, v32, do32 = (torch.randn(b, t, d, device=dev, generator=gen)
                           for _ in range(4))
    pk32, pq32 = (torch.randn(2 * t, d, device=dev, generator=gen)
                  for _ in range(2))
    # padded tails from 1 to T valid keys, and a row with no valid key
    lengths = torch.linspace(1, t, b - 1, device=dev).round().long()
    mask = torch.cat([torch.arange(t, device=dev)[None] < lengths[:, None],
                      torch.zeros(1, t, dtype=torch.bool, device=dev)]).int()
    scale = 1.0 / math.sqrt(3.0 * d // h)
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        args = [x.to(dtype) for x in (q32, k32, v32, pk32, pq32)]
        do = do32.to(dtype)
        got = DA.deberta_attention_bwd(*args, mask, do, h, scale)
        torch.cuda.synchronize()
        want = DA.deberta_attention_bwd_plain(*[x.float() for x in args],
                                              mask, do.float(), h, scale)
        errs.append(_check_grads(
            "deberta_attn_bwd", f"B={b} T={t} D={d} H={h} {dtype}",
            dict(zip(("dq", "dk", "dv", "dPK", "dPQ"), got)), want,
            (dtype,) * 3 + (torch.float32,) * 2))
    args = [x.to(torch.bfloat16) for x in (q32, k32, v32, pk32, pq32)]
    do = do32.to(torch.bfloat16)
    row = {"ms": _time_ms(lambda: DA.deberta_attention_bwd(
        *args, mask, do, h, scale)),
           "plain_ms": _time_ms(lambda: DA.deberta_attention_bwd_plain(
               *args, mask, do, h, scale)),
           "library_ms": None}
    # reads q, k, v, do and both tables, writes dq, dk, dv (bf16) and the
    # tables' fp32 gradients; 20 B T^2 D operations (the TPU kernel's count)
    row["bound_ms"], row["bound_by"] = _bound_ms(
        2 * (7 * b * t * d + 2 * 2 * t * d) + 4 * 2 * 2 * t * d + b * t,
        20 * b * t * t * d)
    _print_time("deberta_attn_bwd", f"B={b} T={t} D={d} H={h} bf16", row,
                card)
    rec = _record("deberta_attn_bwd",
                  "mmd_tpu_torch/ops/csrc/deberta_attn_bwd.cu",
                  "mmd_tpu/models/deberta.py:464",
                  [(FT_DEBERTA["per_step"], row)], errs,
                  "no single PyTorch call computes it: the c2p and p2c "
                  "terms gather from relative-position tables per (t, s)")
    print(f"kernel deberta_attn_bwd per fine-tuning step "
          f"({FT_DEBERTA['per_step']} launches): kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms  "
          f"[{card}]", flush=True)
    return rec


def phase_swin_train(card: str) -> dict:
    from mmd_tpu_torch.ops import swin_attention as SA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    b, n, log2e = FT_DEBERTA["b"], 64, 1.4426950408889634
    errs = {"fwd": [], "bwd": []}
    rows = {"fwd": [], "bwd": []}
    lib_note = None
    for (nw, c, h), count in FT_SWIN_GEOMS.items():
        dh = c // h

        def unit(x):
            x = x.reshape(nw, b, n, h, dh)
            return (x / x.norm(dim=-1, keepdim=True)).reshape(nw, b, n, c)

        # q' as the model makes it: normalized, times a logit scale of 10
        # and log2(e); k normalized; the bias a position bias in (0, 16)
        # plus twice a -100 region mask in the shifted stages, log2 domain
        q32 = unit(torch.randn(nw, b, n, c, device=dev, generator=gen)
                   ) * (10 * log2e)
        k32 = unit(torch.randn(nw, b, n, c, device=dev, generator=gen))
        v32, do32 = (torch.randn(nw, b, n, c, device=dev, generator=gen)
                     for _ in range(2))
        bias = 16 * torch.rand(nw, h, n, n, device=dev, generator=gen)
        if nw > 1:
            bias = bias - 200.0 * (torch.rand(nw, 1, n, n, device=dev,
                                              generator=gen) < 0.3)
        bias = (bias * log2e).contiguous()
        what = f"nW={nw} B={b} C={c} h={h}"
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = (x.to(dtype) for x in (q32, k32, v32, do32))
            o = SA.swin_window_attention_fwd(q, k, v, bias, h)
            got = SA.swin_window_attention_bwd(q, k, v, bias, do, h)
            torch.cuda.synchronize()
            ref = SA.swin_window_attention_plain(q.float(), k.float(),
                                                 v.float(), bias, h)
            errs["fwd"].append(_check_grads(
                "swin_attn_train_fwd", f"{what} {dtype}", {"o": o}, [ref],
                (dtype,)))
            want = SA.swin_window_attention_bwd_plain(
                q.float(), k.float(), v.float(), bias, do.float(), h)
            errs["bwd"].append(_check_grads(
                "swin_attn_train_bwd", f"{what} {dtype}",
                dict(zip(("dq", "dk", "dv", "dbias"), got)), want,
                (dtype,) * 3 + (torch.float32,)))
        q, k, v, do = (x.to(torch.bfloat16) for x in (q32, k32, v32, do32))
        # the library call: SDPA on (nW B, h, n, dh), exp2(x) = exp(ln2 x),
        # the bias as an additive mask in the inputs' dtype
        ln2 = math.log(2.0)
        q4, k4, v4, do4 = (x.reshape(nw, b, n, h, dh).transpose(2, 3)
                           .reshape(nw * b, h, n, dh).contiguous()
                           for x in (q, k, v, do))
        m4 = (ln2 * bias)[:, None].expand(nw, b, h, n, n).reshape(
            nw * b, h, n, n).to(torch.bfloat16).contiguous()
        fwd = {"ms": _time_ms(lambda: SA.swin_window_attention_fwd(
            q, k, v, bias, h)),
               "plain_ms": _time_ms(lambda: SA.swin_window_attention_plain(
                   q, k, v, bias, h)),
               "library_ms": _time_ms(lambda: sdpa(q4, k4, v4, attn_mask=m4,
                                                   scale=ln2))}
        bwd = {"ms": _time_ms(lambda: SA.swin_window_attention_bwd(
            q, k, v, bias, do, h)),
               "plain_ms": _time_ms(lambda: SA.swin_window_attention_bwd_plain(
                   q, k, v, bias, do, h))}
        leaves = [x.detach().requires_grad_() for x in (q4, k4, v4, m4)]
        try:
            o4 = sdpa(*leaves[:3], attn_mask=leaves[3], scale=ln2)
            bwd["library_ms"] = _time_ms(lambda: torch.autograd.grad(
                o4, leaves, do4, retain_graph=True))
        except RuntimeError as e:           # no backend gives dmask
            bwd["library_ms"] = None
            lib_note = f"SDPA's backward with a mask gradient: {e}"[:200]
        elems = nw * b * n * c
        fwd["bound_ms"], fwd["bound_by"] = _bound_ms(
            2 * 4 * elems + 4 * nw * h * n * n, 4 * nw * b * n * n * c)
        bwd["bound_ms"], bwd["bound_by"] = _bound_ms(
            2 * 7 * elems + 2 * 4 * nw * h * n * n, 10 * nw * b * n * n * c)
        for kind, row in (("fwd", fwd), ("bwd", bwd)):
            _print_time(f"swin_attn_train_{kind}", f"{what} n={n} bf16", row,
                        card)
            rows[kind].append((count, row))
    recs = {}
    for kind, line in (("fwd", 211), ("bwd", 314)):
        name = f"swin_attn_train_{kind}"
        recs[name] = _record(
            name, "mmd_tpu_torch/ops/csrc/swin_window_attn_train.cu",
            f"mmd_tpu/ops/swin_attention.py:{line}", rows[kind],
            errs[kind],
            None if kind == "fwd" or lib_note is None else lib_note)
        print(f"kernel {name} per fine-tuning step "
              f"({sum(FT_SWIN_GEOMS.values())} launches): kernel "
              f"{recs[name]['ms']:.4f} ms, plain {recs[name]['plain_ms']:.4f} "
              f"ms, library {recs[name]['library_ms']}, bound "
              f"{recs[name]['bound_ms']:.4f} ms  [{card}]", flush=True)
    return recs



def _check_result(res: dict, claim_img: bool, ev_img: bool) -> None:
    want_present = {"text_text": True, "text_image": ev_img,
                    "image_text": claim_img,
                    "image_image": claim_img and ev_img}
    for path, present in want_present.items():
        if (res[path] is not None) != present:
            fail(f"path {path} came back {'empty' if present else 'filled'} "
                 f"for a request {'with' if present else 'without'} its image")
        if res[path] is None:
            continue
        probs = list(res[path]["probabilities"].values())
        if res[path]["label"] not in ("support", "not_enough_information",
                                      "refute"):
            fail(f"invalid label {res[path]['label']!r}")
        if not all(math.isfinite(p) for p in probs) or abs(sum(probs) - 1) > 1e-5:
            fail(f"probabilities {probs} are not a distribution")


def _fp32(cfg, fused: bool):
    """cfg in float32 with every kernel switch it has set to `fused`."""
    kw = {f: fused for f in ("fused_attn", "fused_ln")
          if f in {x.name for x in dataclasses.fields(cfg)}}
    return dataclasses.replace(cfg, compute_dtype="float32", **kw)


def serve(phase: str, card: str, tmp: Path, texts: list[str],
          images: list[str], want_per_batch: dict, n_req: int,
          reference_families: bool) -> dict:
    """Drive a ServingEngine at full width from several threads; return
    the kernel launches of the counted run, by kernel."""
    from mmd_tpu_torch.core.config import ModelConfig
    from mmd_tpu_torch.inference.predictor import MisinformationPredictor
    from mmd_tpu_torch.inference.server import ServingEngine
    from mmd_tpu_torch.models.frozen import load_or_init_frozen

    t0 = time.perf_counter()
    enc = load_or_init_frozen(tmp / f"assets_{phase}", vocab_texts=texts,
                              vocab_size=30000, seed=0,
                              reference_families=reference_families)
    cfg = ModelConfig(fused_attn=True)
    pred = MisinformationPredictor(cfg, encoders=enc, max_length=512,
                                   batch_size=BATCH, device="cuda")
    tc, vc = enc.text_cfg, enc.vit_cfg
    print(f"{phase}: encoders {type(tc).__name__} {tc.num_layers}x"
          f"{tc.hidden_size} (vocab {tc.vocab_size}, {tc.compute_dtype}), "
          f"{type(vc).__name__} {vc.num_tokens}x{vc.hidden_size} tokens at "
          f"{vc.image_size} px ({vc.compute_dtype}); fusion {cfg.embed_dim}/"
          f"{cfg.num_heads} heads, {cfg.compute_dtype}; set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # warm-up batch (allocator, cuBLAS handles) outside the counted run
    pred.evaluate_batch(texts[:BATCH], (images + [None] * BATCH)[:BATCH],
                        texts[BATCH:2 * BATCH], [None] * BATCH)
    torch.cuda.synchronize()

    n_threads = 6
    reqs = []
    for i in range(n_req):
        ci = images[i % len(images)] if i % 2 == 0 else None
        ei = images[(i * 5) % len(images)] if i % 3 != 2 else None
        reqs.append((texts[i % len(texts)], ci,
                     texts[(i * 7 + 3) % len(texts)], ei))
    results: dict[int, dict] = {}
    errors: list[BaseException] = []
    lock = threading.Lock()

    _reset_counts()                       # count the main path's run only
    eng = ServingEngine(pred, max_batch=BATCH, max_wait_ms=20.0)

    def client(idx: list[int]) -> None:
        futs = [(i, eng.submit(*reqs[i], detailed=True)) for i in idx]
        for i, f in futs:
            try:
                r = f.result(timeout=600)
            except BaseException as e:  # reported below, never dropped
                with lock:
                    errors.append(e)
                continue
            with lock:
                results[i] = r

    threads = [threading.Thread(target=client,
                                args=(list(range(j, n_req, n_threads)),))
               for j in range(n_threads)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
    finally:
        eng.close()
    torch.cuda.synchronize()
    launches = _counts()
    st = eng.stats()
    if errors:
        fail(f"{phase}: {len(errors)} requests failed: {errors[0]!r}")
    if any(th.is_alive() for th in threads) or len(results) != n_req:
        fail(f"{phase}: {n_req - len(results)} requests never resolved")
    for i, (_, ci, _, ei) in enumerate(reqs):
        _check_result(results[i], ci is not None, ei is not None)
    want = {name: want_per_batch.get(name, 0) * st["batches"]
            for name in launches}
    print(f"{phase}: {st['served']} requests in {st['batches']} batches "
          f"(mean fill {st['mean_batch_fill']:.2f}), latency p50 "
          f"{st['latency_p50_ms']:.2f} ms, p95 {st['latency_p95_ms']:.2f} "
          f"ms, kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})  [{card}]", flush=True)
    print(f"{phase}: stage seconds {json.dumps(st['stages_s'])}", flush=True)
    if launches != want:
        fail(f"{phase}: launches {launches} for {st['batches']} batches; the "
             f"path should launch {want}")

    # one fp32 batch through the kernel path and the explicit path, same
    # params: the served probabilities must agree
    def fp32_predictor(fused: bool):
        e = dataclasses.replace(enc, text_cfg=_fp32(enc.text_cfg, fused),
                                vit_cfg=_fp32(enc.vit_cfg, fused))
        return MisinformationPredictor(
            _fp32(cfg, fused), fusion_params=pred.params.state_dict(),
            encoders=e, max_length=512, batch_size=BATCH, device="cuda")

    batch = ([r[0] for r in reqs[:BATCH]], [r[1] for r in reqs[:BATCH]],
             [r[2] for r in reqs[:BATCH]], [r[3] for r in reqs[:BATCH]])
    got = fp32_predictor(True).evaluate_batch(*batch, detailed=True)
    ref = fp32_predictor(False).evaluate_batch(*batch, detailed=True)
    diff = max(abs(g[p]["probabilities"][c] - r[p]["probabilities"][c])
               for g, r in zip(got, ref) for p in g if g[p] is not None
               for c in g[p]["probabilities"])
    print(f"{phase}: fp32 kernel path vs explicit path, max probability "
          f"difference {diff:.3e} (tol {PROB_TOL:.0e})", flush=True)
    if not diff <= PROB_TOL:
        fail(f"{phase}: the kernel path disagrees with the explicit path")
    return launches


def phase_train(card: str, tmp: Path, phase: str, per_step: dict,
                dtype_args: list) -> dict:
    """python -m mmd_tpu_torch.train's main path at full width, with
    `dtype_args` (none: the default bf16): returns the kernel launches of
    the counted run, which must be `per_step` a step."""
    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.training.loop import run_training

    out = tmp / phase
    argv = ["--device", "cuda", "--synthetic_samples",
            str(TRAIN_STEPS * TRAIN_B), "--batch_size", str(TRAIN_B),
            "--epochs", "1", *dtype_args, "--fused_attn",
            "--dropout", str(DROPOUT_RATE), "--log_every", "1",
            "--save_every", "4", "--validate_every_epoch",
            "--output_dir", str(out)]
    t0 = time.perf_counter()
    args = TR.parse_args(argv)
    cfg, trainer, train_batches, val_batches = TR.build(args)
    n_val = len(list(val_batches()))
    m = cfg.model
    print(f"{phase}: fusion {m.embed_dim} wide, {m.num_heads} heads, hidden "
          f"{m.hidden_dim}, text {m.text_input_dim} x 512, image "
          f"{m.image_input_dim} x 64, batch {cfg.batch_size}, "
          f"{m.compute_dtype}, fused_attn={m.fused_attn}, dropout "
          f"{m.dropout}; {TRAIN_STEPS} steps, {n_val} validation batches; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                       # count the main path's run only
    t0 = time.perf_counter()
    state = run_training(trainer, train_batches, val_batches)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update({k: v * TRAIN_STEPS for k, v in per_step.items()})
    want["flash_attn_fwd"] += FUSION_PER_BATCH * n_val
    print(f"{phase}: {state.step} steps + {n_val} validation batches in "
          f"{run_s:.2f} s, kernel launches {json.dumps(launches)} (want "
          f"{json.dumps(want)})  [{card}]", flush=True)
    if launches != want:
        fail(f"{phase}: launches {launches}; the path should launch {want}")

    recs = [json.loads(x) for x in
            (out / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/total_loss"] for r in recs if "train/total_loss" in r]
    val = [r for r in recs if "val/loss" in r]
    print(f"{phase}: loss by step {json.dumps(losses)}; validation loss "
          f"{val[0]['val/loss'] if val else None}, avg_f1 "
          f"{val[0].get('val/avg_f1') if val else None}", flush=True)
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"{phase}: losses {losses}")
    if len(val) != 1 or not math.isfinite(val[0]["val/loss"]):
        fail(f"{phase}: validation records {val}")
    ckpts = sorted(p.name for p in (out / "checkpoints").iterdir())
    want_ckpts = sorted({f"step_{i}.pt" for i in range(4, TRAIN_STEPS + 1, 4)}
                        | {f"step_{TRAIN_STEPS}.pt"})
    if ckpts != want_ckpts:
        fail(f"{phase}: checkpoints {ckpts}, want {want_ckpts}")
    init = trainer.init().params.state_dict()
    moved = [k for k, x in state.params.state_dict().items()
             if not torch.equal(x, init[k])]
    if len(moved) < len(init) // 2:
        fail(f"{phase}: only {len(moved)} of {len(init)} params moved")

    batch = trainer.shard_batch(next(iter(train_batches(0))))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    print(f"{phase}: wall per step after torch.cuda.synchronize() "
          f"{json.dumps([round(x, 3) for x in times])} ms; "
          f"{len(moved)} of {len(init)} params moved; checkpoints {ckpts}; "
          f"peak device memory {peak / 2 ** 30:.3f} GiB "
          f"(torch.cuda.max_memory_allocated)  [{card}]", flush=True)
    return launches


def phase_train_parity(card: str) -> None:
    """One fp32 step with dropout on, fused and explicit attention, one
    seed: the same masks, so the same step."""
    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    batch = synthetic_preembed_batch(np.random.default_rng(1), BATCH)
    out = {}
    for fused in (True, False):
        cfg = TrainConfig(model=ModelConfig(compute_dtype="float32",
                                            fused_attn=fused,
                                            dropout=DROPOUT_RATE),
                          batch_size=BATCH)
        tr = Trainer(cfg, device="cuda")
        state = tr.init()
        state, aux = tr.train_step(state, tr.shard_batch(batch))
        out[fused] = (float(aux["loss"]),
                      {n: p.grad.detach().clone()
                       for n, p in state.params.named_parameters()})
        del tr, state
    (lf, gf), (le, ge) = out[True], out[False]
    loss_rel = abs(lf - le) / abs(le)
    worst, where = _grad_gap(gf, ge)
    ok = loss_rel <= PARITY_LOSS_RTOL and worst <= PARITY_GRAD_RTOL
    print(f"train_parity: batch {BATCH}, fp32, dropout {DROPOUT_RATE}: loss "
          f"fused {lf:.7f} explicit {le:.7f}, relative {loss_rel:.3e} (tol "
          f"{PARITY_LOSS_RTOL:.0e}); worst grad leaf {where} at "
          f"{worst:.3e} of its scale (tol {PARITY_GRAD_RTOL:.0e}) -> "
          f"{'ok' if ok else 'FAIL'}  [{card}]", flush=True)
    if not ok:
        fail("train_parity: the kernel path and the explicit path disagree")


def _grad_gap(got: dict, want: dict) -> tuple[float, str]:
    """The worst leaf's max-abs gap relative to its largest |want|, no leaf
    held to less than PARITY_FLOOR of the model's largest gradient."""
    top = max(w.abs().max().item() for w in want.values())
    worst, where = 0.0, None
    for n, w in want.items():
        scale = max(w.abs().max().item(), PARITY_FLOOR * top)
        r = (got[n] - w).abs().max().item() / scale
        if r > worst:
            worst, where = r, n
    return worst, where


def phase_train_parity_bf16(card: str) -> None:
    """One bf16 step with dropout on at batch 16 and full width, through the
    fused MLP kernels and through the unfused MLP, one seed: the same
    masks, so the same step up to bf16 rounding. The fused path with a
    wrong step seed must then fail the same check."""
    from unittest import mock

    from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.models import layers as L
    from mmd_tpu_torch.ops import mlp as M
    from mmd_tpu_torch.training.trainer import Trainer

    batch = synthetic_preembed_batch(np.random.default_rng(1), BATCH)
    cfg = TrainConfig(model=ModelConfig(fused_attn=True,
                                        dropout=DROPOUT_RATE),
                      batch_size=BATCH)

    def step(fused: bool, seed_shift: int = 0, dtype: str = "bfloat16"):
        tr = Trainer(dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, compute_dtype=dtype)), device="cuda")
        state = tr.init()
        state.seed += seed_shift
        was = (M.launches, M.bwd_launches)
        with mock.patch.object(L, "needs_fused_mlp",
                               L.needs_fused_mlp if fused
                               else lambda *a: False):
            state, aux = tr.train_step(state, tr.shard_batch(batch))
        torch.cuda.synchronize()
        launched = (M.launches - was[0], M.bwd_launches - was[1])
        want = (MLP_PER_STEP,) * 2 if fused and dtype == "bfloat16" \
            else (0, 0)
        if launched != want:
            fail(f"train_parity_bf16: the {'fused' if fused else 'unfused'}"
                 f" step launched {launched} MLP kernels, want {want}")
        return float(aux["loss"]), {n: p.grad.detach().float().clone()
                                    for n, p in
                                    state.params.named_parameters()}

    def l2_gap(got: dict, want: dict) -> float:
        """|got - want| / |want| over all leaves as one vector."""
        return math.sqrt(
            sum((got[n] - w).double().square().sum().item()
                for n, w in want.items())
            / sum(w.double().square().sum().item() for w in want.values()))

    le, ge = step(False)
    # the fp32 step on the same masks, to show the size of bf16's rounding
    l32, g32 = step(False, dtype="float32")
    results = {}
    for name, shift in (("fused", 0), ("fused, wrong seed", 1)):
        lf, gf = step(True, shift)
        loss_rel = abs(lf - le) / abs(le)
        grad_rel = l2_gap(gf, ge)
        worst, where = _grad_gap(gf, ge)
        if not shift:
            print(f"train_parity_bf16: against the fp32 step ({l32:.7f}): "
                  f"gradient L2 gap {l2_gap(gf, g32):.3e} fused, "
                  f"{l2_gap(ge, g32):.3e} unfused", flush=True)
        ok = (loss_rel <= PARITY_BF16_LOSS_RTOL
              and grad_rel <= PARITY_BF16_GRAD_RTOL)
        results[name] = ok
        print(f"train_parity_bf16: batch {BATCH}, bf16, dropout "
              f"{DROPOUT_RATE}: loss {name} {lf:.7f} unfused {le:.7f}, "
              f"relative {loss_rel:.3e} (tol {PARITY_BF16_LOSS_RTOL:.0e}); "
              f"gradient L2 gap {grad_rel:.3e} of its norm (tol "
              f"{PARITY_BF16_GRAD_RTOL:.0e}); worst leaf {where} at "
              f"{worst:.3e} of its scale -> {'ok' if ok else 'FAIL'}  "
              f"[{card}]", flush=True)
    if not results["fused"]:
        fail("train_parity_bf16: the fused and the unfused MLP disagree")
    if results["fused, wrong seed"]:
        fail("train_parity_bf16: a wrong seed passed the check, which "
             "therefore shows nothing")


def phase_finetune_reference(card: str, tmp: Path) -> dict:
    """FT_STEPS steps of the reference fine-tuning configuration through
    Trainer(finetune=True): returns the kernel launches of the run, which
    must be FT_PER_STEP a step."""
    from mmd_tpu_torch.profile_train import (FT_BATCH, FT_SEQ, raw_batch,
                                             reference_encoders,
                                             reference_finetune)

    t0 = time.perf_counter()
    enc = reference_encoders(tmp / "ft_assets")
    trainer = reference_finetune(enc)
    state = trainer.init()
    tc, vc, m = enc.text_cfg, enc.vit_cfg, trainer.cfg.model
    print(f"finetune_reference: DeBERTa-v3-xsmall ({tc.num_layers} layers, "
          f"D {tc.hidden_size}, {tc.num_heads} heads, {tc.compute_dtype}, "
          f"fused_train={tc.fused_train}) + Swinv2-base (depths {vc.depths}, "
          f"C {vc.embed_dim}..{vc.hidden_size}, window {vc.window_size}, "
          f"{vc.compute_dtype}, fused_train={vc.fused_train}); fusion "
          f"{m.embed_dim} wide, {m.compute_dtype}, dropout {m.dropout}; "
          f"batch {FT_BATCH}, {FT_SEQ} tokens, {vc.image_size} px; "
          f"{sum(p.numel() for p in state.params.parameters())} params; "
          f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    batches = [raw_batch(rng, FT_BATCH, FT_SEQ, tc.vocab_size, vc.image_size)
               for _ in range(FT_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()                       # count the main path's run only
    losses, times = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, aux = trainer.train_step(state, trainer.shard_batch(batch))
        losses.append(float(aux["loss"]))  # synchronizes
        times.append(1e3 * (time.perf_counter() - t0))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: 0 for name in launches}
    want.update({k: v * FT_STEPS for k, v in FT_PER_STEP.items()})
    print(f"finetune_reference: {state.step} steps, kernel launches "
          f"{json.dumps(launches)} (want {json.dumps(want)})  [{card}]",
          flush=True)
    if launches != want:
        fail(f"finetune_reference: launches {launches}; the path should "
             f"launch {want}")
    print(f"finetune_reference: loss by step {json.dumps(losses)}; wall per "
          f"step {json.dumps([round(x, 3) for x in times])} ms (median "
          f"{sorted(times)[len(times) // 2]:.3f}); peak device memory "
          f"{peak / 2 ** 30:.3f} GiB (torch.cuda.max_memory_allocated)  "
          f"[{card}]", flush=True)
    if not all(map(math.isfinite, losses)):
        fail(f"finetune_reference: losses {losses}")
    return launches


def phase_finetune_parity(card: str, tmp: Path) -> None:
    """One fp32 step at batch 2, dropout 0, of the reference fine-tuning
    configuration through the kernels and through both encoders' explicit
    paths: the same step up to the order of fp32 sums."""
    from mmd_tpu_torch.profile_train import (FT_SEQ, raw_batch,
                                             reference_encoders,
                                             reference_finetune)

    enc = reference_encoders(tmp / "parity_assets")
    batch = raw_batch(np.random.default_rng(6), 2, FT_SEQ,
                      enc.text_cfg.vocab_size, enc.vit_cfg.image_size)
    out = {}
    for kernels in (True, False):
        fp32 = dict(compute_dtype="float32", fused_attn=kernels)
        variant = dataclasses.replace(
            enc, text_cfg=dataclasses.replace(enc.text_cfg, **fp32),
            vit_cfg=dataclasses.replace(enc.vit_cfg, **fp32))
        trainer = reference_finetune(variant, batch_size=2,
                                     compute_dtype="float32", dropout=0.0)
        state = trainer.init()
        was = _counts()
        state, aux = trainer.train_step(state, trainer.shard_batch(batch))
        torch.cuda.synchronize()
        ran = {k: v - was[k] for k, v in _counts().items()
               if k.startswith(("deberta", "swin")) and v != was[k]}
        print(f"finetune_parity: {'kernels' if kernels else 'explicit'} "
              f"path launched {json.dumps(ran)}", flush=True)
        if bool(ran) != kernels or (kernels and len(ran) != 4):
            fail(f"finetune_parity: the {'kernel' if kernels else 'explicit'}"
                 f" path launched {ran}")
        out[kernels] = (float(aux["loss"]), {
            tree: [p.grad.detach().double().clone()
                   for p in state.params[tree].parameters()]
            for tree in ("fusion", "text", "vit")})
        del trainer, state
    (lk, gk), (le, ge) = out[True], out[False]
    loss_rel = abs(lk - le) / abs(le)
    gaps = {tree: math.sqrt(
        sum((a - w).square().sum().item() for a, w in zip(gk[tree], ge[tree]))
        / sum(w.square().sum().item() for w in ge[tree])) for tree in gk}
    ok = (loss_rel <= FT_PARITY_LOSS_RTOL
          and max(gaps.values()) <= FT_PARITY_GRAD_RTOL)
    print(f"finetune_parity: batch 2, fp32, dropout 0: loss kernels "
          f"{lk:.7f} explicit {le:.7f}, relative {loss_rel:.3e} (tol "
          f"{FT_PARITY_LOSS_RTOL:.0e}); gradient L2 gap by tree "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})} "
          f"(tol {FT_PARITY_GRAD_RTOL:.0e}) -> {'ok' if ok else 'FAIL'}  "
          f"[{card}]", flush=True)
    if not ok:
        fail("finetune_parity: the kernel path and the explicit path "
             "disagree")


def phase_train_raw(card: str, tmp: Path) -> dict:
    """The raw path of python -m mmd_tpu_torch.train on a synthetic Factify
    tree, frozen and then --finetune_encoders, with the default encoder
    families: returns the kernel launches of both runs."""
    import os

    from mmd_tpu_torch import train as TR
    from mmd_tpu_torch.data.synthetic import synthetic_factify_tree
    from mmd_tpu_torch.pipelines.preprocess import preprocess_csv

    root = tmp / "factify"
    t0 = time.perf_counter()
    synthetic_factify_tree(root, n_train=64, n_test=8, image_size=256)
    csv = preprocess_csv("train", root)
    print(f"train_raw: tree and preprocessed csv in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cwd = os.getcwd()
    os.environ["MMD_TPU_ROOT"] = str(root)
    os.chdir(root)                   # the encoders' assets land in the tree
    total = {}
    try:
        for name, extra, per_step in (
                ("frozen", [], RAW_FROZEN_PER_STEP),
                ("finetune", ["--finetune_encoders"], RAW_FINETUNE_PER_STEP)):
            out = root / f"run_{name}"
            argv = ["--device", "cuda", "--train_data", str(csv),
                    "--batch_size", "8", "--epochs", "2", "--fused_attn",
                    "--log_every", "1", "--output_dir", str(out), *extra]
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            state = TR.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches = _counts()
            want = {k: 0 for k in launches}
            want.update({k: v * state.step for k, v in per_step.items()})
            recs = [json.loads(x) for x in
                    (out / "metrics.jsonl").read_text().splitlines()]
            losses = [r["train/total_loss"] for r in recs
                      if "train/total_loss" in r]
            print(f"train_raw {name}: {state.step} steps in {run_s:.1f} s "
                  f"(raw store, encoders and checkpoint included); loss by "
                  f"step {json.dumps(losses)}; launches "
                  f"{json.dumps(launches)} (want {json.dumps(want)})  "
                  f"[{card}]", flush=True)
            if launches != want:
                fail(f"train_raw {name}: launches {launches}, want {want}")
            if len(losses) != state.step or state.step < 2 or not all(
                    map(math.isfinite, losses)):
                fail(f"train_raw {name}: losses {losses}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
    finally:
        os.chdir(cwd)
        del os.environ["MMD_TPU_ROOT"]
    return total



def main() -> None:
    dev = phase_device()
    phase_build()
    recs = {"flash_attn_fwd": phase_flash(dev["card"]),
            "layernorm": phase_layernorm(dev["card"]),
            "swin_window_attn": phase_swin(dev["card"]),
            "deberta_attn_fwd": phase_deberta(dev["card"]),
            "dropout": phase_dropout(dev["card"]),
            "flash_attn_bwd": phase_flash_bwd(dev["card"])}
    recs["flash_attn_fwd"]["train_step"] = phase_flash_train(dev["card"])
    recs.update(phase_mlp(dev["card"]))
    recs["deberta_attn_bwd"] = phase_deberta_bwd(dev["card"])
    recs.update(phase_swin_train(dev["card"]))
    from mmd_tpu_torch.inference.traffic import corpus, write_images
    rng = np.random.default_rng(0)
    texts = corpus(rng, 64)
    with tempfile.TemporaryDirectory(prefix="mmd_chip_smoke_") as tmp:
        tmp = Path(tmp)
        images = write_images(tmp, rng, 12)
        by_phase = {
            "serve": serve("serve", dev["card"], tmp, texts, images,
                           {"flash_attn_fwd": LAUNCHES_PER_BATCH}, 48, False),
            "serve_reference": serve("serve_reference", dev["card"], tmp,
                                     texts, images, REFERENCE_PER_BATCH, 48,
                                     True),
            "train": phase_train(dev["card"], tmp, "train", PER_STEP,
                                 ["--compute_dtype", "float32"]),
            "train_bf16": phase_train(dev["card"], tmp, "train_bf16",
                                      PER_STEP_BF16, []),
            "finetune_reference": phase_finetune_reference(dev["card"], tmp),
            "train_raw": phase_train_raw(dev["card"], tmp)}
        phase_train_parity(dev["card"])
        phase_train_parity_bf16(dev["card"])
        phase_finetune_parity(dev["card"], tmp)
    kernels = []
    for name, rec in recs.items():
        counts = {ph: launches[name] for ph, launches in by_phase.items()}
        kernels.append({**rec, "launches": sum(counts.values()),
                        "launches_by_phase": counts})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}),
        flush=True)


if __name__ == "__main__":
    main()
