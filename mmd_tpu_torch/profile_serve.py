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
import tempfile
from pathlib import Path

import numpy as np
import torch

from mmd_tpu_torch import profiling as P
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reference_families", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = P.card()
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
        files_ms = P.timed(from_files, BATCHES)
        arrays_ms = P.timed(from_arrays, BATCHES)
        print(json.dumps({
            "encoders": [type(enc.text_cfg).__name__,
                         type(enc.vit_cfg).__name__],
            "batch": BATCH, "batches": BATCHES,
            "files_ms_median": statistics.median(files_ms),
            "arrays_ms_median": statistics.median(arrays_ms),
            "files_ms": files_ms, "arrays_ms": arrays_ms, "card": card}),
            flush=True)

        summary = P.profile_window(from_arrays, 3, KERNELS)
    print(json.dumps({"profiled_batches": 3, **summary, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
