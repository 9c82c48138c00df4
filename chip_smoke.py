"""Smoke run of the PyTorch port's serving paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:
  1. device   a CUDA device, its name and power limit (nvidia-smi), TF32 off
  2. build    nvcc builds the four kernels from ops/csrc/, all at once
  3. kernels  each kernel against its plain PyTorch version on the card, at
              every geometry of the serving paths, bf16 and fp32: max-abs
              error against its tolerance; kernel, plain and library times
              from CUDA events; the bound (the least time the card could
              take: bytes over 3.35 TB/s or bf16 operations over 989
              TFLOP/s, whichever is larger), all beside the card's name
     * flash_attn_fwd        exact zeros for a row with no valid key, lse
     * layernorm             (residual +) LayerNorm, the 53 of a Swinv2 forward
     * swin_window_attn      Swinv2 window attention, the 24 of a forward
     * deberta_attn_fwd      DeBERTa attention, the uniform row of a row
                             with no valid key
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
The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record.
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


def _ops():
    from mmd_tpu_torch.ops import attention, deberta_attention, ln, \
        swin_attention
    return {"flash_attn_fwd": attention, "layernorm": ln,
            "swin_window_attn": swin_attention,
            "deberta_attn_fwd": deberta_attention}


def phase_build() -> None:
    from mmd_tpu_torch.ops import cuda_build
    ops = _ops()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(ops)) as ex:     # one nvcc per source
        list(ex.map(lambda m: m.load_kernel(), ops.values()))
    for name in ops:
        secs = cuda_build.build_seconds.get(name)
        print(f"build: {name} nvcc "
              f"{'%.3f s' % secs if secs is not None else 'skipped: built'}",
              flush=True)
    print(f"build: all four loaded in {time.perf_counter() - t0:.3f} s",
          flush=True)


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
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

    ops = _ops()
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

    for m in ops.values():                # count the main path's run only
        m.launches = 0
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
    launches = {name: m.launches for name, m in ops.items()}
    st = eng.stats()
    if errors:
        fail(f"{phase}: {len(errors)} requests failed: {errors[0]!r}")
    if any(th.is_alive() for th in threads) or len(results) != n_req:
        fail(f"{phase}: {n_req - len(results)} requests never resolved")
    for i, (_, ci, _, ei) in enumerate(reqs):
        _check_result(results[i], ci is not None, ei is not None)
    want = {name: want_per_batch.get(name, 0) * st["batches"] for name in ops}
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


def main() -> None:
    dev = phase_device()
    phase_build()
    recs = {"flash_attn_fwd": phase_flash(dev["card"]),
            "layernorm": phase_layernorm(dev["card"]),
            "swin_window_attn": phase_swin(dev["card"]),
            "deberta_attn_fwd": phase_deberta(dev["card"])}
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
                                     True)}
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
