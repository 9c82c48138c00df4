"""Where a served batch's time goes, on one NVIDIA GPU.

    python -m mmd_tpu_torch.profile_serve [--reference_families]

Builds the full-width predictor that chip_smoke.py serves (batch 16, 512
tokens, ModelConfig(fused_attn=True), bf16, random weights from seed 0; the
BERT-class text encoder and the ViT, or with --reference_families
DeBERTa-v3-xsmall and Swinv2-base), warms it up, then prints JSON lines:

  1. the card's name and power limit (nvidia-smi);
  2. host-clock milliseconds for each of 10 batches, each ending in
     torch.cuda.synchronize(): from PNG files (evaluate_batch) and from
     decoded uint8 arrays (evaluate_arrays), median and all runs;
  3. a torch.profiler window (CPU and CUDA activities) over three
     evaluate_arrays batches: device busy time (the sum of kernel and copy
     times on the card), the window, the idle share, the launches, and
     device time by operation, the port's kernels named.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.inference.predictor import MisinformationPredictor
from mmd_tpu_torch.inference.traffic import corpus, write_images
from mmd_tpu_torch.models.frozen import load_or_init_frozen

BATCH = 16
BATCHES = 10                 # timed batches on the host clock
# kernel symbol -> the port's kernel (the CUDA sources under ops/csrc/)
KERNELS = {"flash_fwd_kernel": "flash_attn_fwd", "ln_kernel": "layernorm",
           "swin_attn_kernel": "swin_window_attn",
           "deberta_attn_kernel": "deberta_attn_fwd"}
# substring of a library kernel's name -> its group
GROUPS = (("Memcpy", "copies"), ("gemm", "matmul"), ("xmma", "matmul"),
          ("cutlass", "matmul"), ("nvjet", "matmul"), ("roll_cuda", "roll"),
          ("copy_kern", "dtype casts"), ("softmax", "softmax"),
          ("layer_norm", "layer_norm"), ("reduce", "reductions"),
          ("elementwise", "elementwise"), ("CatArray", "cat"),
          ("index", "index/gather"), ("gather", "index/gather"))


def _device_us(evt) -> float:
    """Microseconds of a device-side event (a kernel or a copy); 0 for the
    host-side operators, whose device time their kernels already carry."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _timed(fn, n: int) -> list[float]:
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference_families", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)

    rng = np.random.default_rng(0)
    texts = corpus(rng, 64)
    with tempfile.TemporaryDirectory(prefix="mmd_profile_") as tmp:
        tmp = Path(tmp)
        images = write_images(tmp, rng, 2 * BATCH)
        enc = load_or_init_frozen(tmp / "assets", vocab_texts=texts,
                                  vocab_size=30000, seed=0,
                                  reference_families=args.reference_families)
        pred = MisinformationPredictor(ModelConfig(fused_attn=True),
                                       encoders=enc, max_length=512,
                                       batch_size=BATCH, device="cuda")
        claims, evidence = texts[:BATCH], texts[BATCH:2 * BATCH]
        x_img, e_img = images[:BATCH], images[BATCH:]
        x_u8, x_ok = pred.decode_images(x_img)
        e_u8, e_ok = pred.decode_images(e_img)

        def from_files():
            pred.evaluate_batch(claims, x_img, evidence, e_img)

        def from_arrays():
            pred.evaluate_arrays(claims, x_u8, x_ok, evidence, e_u8, e_ok)

        for _ in range(3):
            from_files()
        torch.cuda.synchronize()
        files_ms = _timed(from_files, BATCHES)
        arrays_ms = _timed(from_arrays, BATCHES)
        print(json.dumps({
            "encoders": [type(enc.text_cfg).__name__,
                         type(enc.vit_cfg).__name__],
            "batch": BATCH, "batches": BATCHES,
            "files_ms_median": statistics.median(files_ms),
            "arrays_ms_median": statistics.median(arrays_ms),
            "files_ms": files_ms, "arrays_ms": arrays_ms, "card": card}),
            flush=True)

        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                from_arrays()
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, float] = {}
    launches = 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0:
            continue
        name = next((v for k, v in KERNELS.items() if k in evt.key), evt.key)
        by_name[name] = by_name.get(name, 0.0) + us
        launches += evt.count
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    groups: dict[str, float] = {}
    for name, us in by_name.items():
        g = name if name in KERNELS.values() else next(
            (v for k, v in GROUPS if k in name), "other")
        groups[g] = groups.get(g, 0.0) + us / 1e3
    print(json.dumps({
        "profiled_batches": 3, "window_ms": window_ms,
        "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / window_ms if window_ms else None,
        "device_events": launches,
        "device_ms_by_group": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
        "device_ms_top": {k[:80]: v / 1e3 for k, v in top},
        "kernels_ms": {v: by_name.get(v, 0.0) / 1e3 for v in KERNELS.values()},
        "card": card}), flush=True)


if __name__ == "__main__":
    main()
