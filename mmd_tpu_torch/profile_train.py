"""Where a train step's time goes, on one NVIDIA GPU.

    python -m mmd_tpu_torch.profile_train [--compute_dtype {bfloat16,float32}]
    python -m mmd_tpu_torch.profile_train --finetune

Builds the train step that chip_smoke.py's train phases run (batch 256,
text 512 x 384, image 64 x 1024, ModelConfig(compute_dtype=<the flag,
bfloat16 by default>, fused_attn=True, dropout=0.1), AdamW, random weights
from seed 42, one synthetic learnable batch already on the card) or, with
--finetune, the fine-tuning step of chip_smoke.py's finetune_reference
phase (`reference_encoders`, `reference_finetune`: DeBERTa-v3-xsmall and
Swinv2-base, seeded, bf16, both with fused_train, training with the
default fusion model at batch 8 and 256 tokens, one synthetic raw batch on
the card), warms it up, then prints JSON lines:

  1. the card's name and power limit (nvidia-smi);
  2. host-clock milliseconds for each of 10 steps, each ending in
     torch.cuda.synchronize(), their median, and the peak device memory
     (torch.cuda.max_memory_allocated);
  3. a torch.profiler window (CPU and CUDA activities) over three steps:
     device busy time (the sum of kernel and copy times on the card), the
     window, the idle share, the launches, and device time by operation,
     the port's kernels named.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile

import numpy as np
import torch

from mmd_tpu_torch import profiling as P
from mmd_tpu_torch.core.config import ModelConfig, TrainConfig
from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
from mmd_tpu_torch.training.trainer import Trainer

BATCH = 256
STEPS = 10                   # timed steps on the host clock
# the fine-tuning step: batch and text length of the JAX package's
# fine-tune benchmarks (benchmarks/bench_deberta_ft_ab.py,
# bench_swin_ft_ab.py)
FT_BATCH, FT_SEQ = 8, 256
# kernel symbol -> the port's kernel (the CUDA sources under ops/csrc/);
# the first symbol a name contains wins
KERNELS = {"deberta_bwd_": "deberta_attn_bwd",
           "deberta_attn_kernel": "deberta_attn_fwd",
           "swin_train_fwd_kernel": "swin_attn_train_fwd",
           "swin_train_bwd_kernel": "swin_attn_train_bwd",
           "swin_train_dbias_kernel": "swin_attn_train_bwd",
           "flash_fwd_kernel": "flash_attn_fwd",
           "rowdot_kernel": "flash_attn_bwd", "dkdv_kernel": "flash_attn_bwd",
           "dq_kernel": "flash_attn_bwd", "dropout_kernel": "dropout",
           "mlp_fwd_kernel": "mlp_fwd", "mlp_dx_kernel": "mlp_bwd",
           "mlp_dw_kernel": "mlp_bwd", "mlp_reduce_kernel": "mlp_bwd"}
# the AdamW update (torch's foreach kernels) and autograd's accumulation
TRAIN_GROUPS = (("multi_tensor_apply", "optimizer"),
                ("foreach", "optimizer"))


def raw_batch(rng: np.random.Generator, batch: int, seq: int, vocab: int,
              image_size: int) -> dict:
    """A raw batch as the raw store yields it: token ids (first token 1)
    with a padded tail on every other row, uint8 images, 4-path labels."""
    from mmd_tpu_torch.data.labels import LABEL_TABLE
    out = {}
    for side in ("claim", "doc"):
        lengths = np.where(np.arange(batch) % 2, seq // 2 + 3, seq)
        mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(1, vocab, size=(batch, seq)).astype(np.int32)
        out[f"{side}_ids"] = ids * mask
        out[f"{side}_mask"] = mask
        out[f"{side}_image"] = rng.integers(
            0, 256, size=(batch, image_size, image_size, 3), dtype=np.uint8)
    out["labels"] = LABEL_TABLE[rng.integers(0, 5, size=batch)].astype(
        np.int32)
    return out


def reference_encoders(assets_dir):
    """The reference encoders, load_or_init_frozen(reference_families=True):
    DeBERTa-v3-xsmall and Swinv2-base, seeded, bf16 (the tokenizer trained
    on a synthetic corpus under `assets_dir`), with Swin's fused_train on --
    the JAX package's opt-in that puts its fine-tuning window-attention
    kernels on the path; DeBERTa's is on by default."""
    from mmd_tpu_torch.inference.traffic import corpus
    from mmd_tpu_torch.models.frozen import load_or_init_frozen

    enc = load_or_init_frozen(assets_dir, reference_families=True,
                              vocab_texts=corpus(np.random.default_rng(0),
                                                 64))
    enc.vit_cfg = dataclasses.replace(enc.vit_cfg, fused_train=True)
    return enc


def reference_finetune(enc, batch_size: int = FT_BATCH,
                       **model_kw) -> Trainer:
    """Trainer(finetune=True) on the card for the encoders `enc` and the
    default fusion model over their outputs (`model_kw` overrides it)."""
    model = ModelConfig(text_input_dim=enc.text_cfg.hidden_size,
                        image_input_dim=enc.vit_cfg.hidden_size,
                        fused_attn=True, **model_kw)
    cfg = TrainConfig(model=model, batch_size=batch_size)
    return Trainer(cfg, device="cuda", encoders=enc, finetune=True)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--compute_dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--finetune", action="store_true",
                   help="the reference fine-tuning step instead")
    args = p.parse_args(argv)
    dtype = args.compute_dtype
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = P.card()
    print(json.dumps({"card": card}), flush=True)

    if args.finetune:
        with tempfile.TemporaryDirectory(prefix="mmd_profile_") as tmp:
            enc = reference_encoders(tmp)
        trainer = reference_finetune(enc)
        batch_size, dtype = FT_BATCH, trainer.cfg.model.compute_dtype
        batch = trainer.shard_batch(raw_batch(
            np.random.default_rng(0), FT_BATCH, FT_SEQ,
            enc.text_cfg.vocab_size, enc.vit_cfg.image_size))
    else:
        cfg = TrainConfig(model=ModelConfig(compute_dtype=dtype,
                                            fused_attn=True, dropout=0.1),
                          batch_size=BATCH)
        trainer, batch_size = Trainer(cfg, device="cuda"), BATCH
        batch = trainer.shard_batch(
            synthetic_preembed_batch(np.random.default_rng(0), BATCH))
    state = trainer.init()

    def step():
        nonlocal state
        state, _ = trainer.train_step(state, batch)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = P.timed(step, STEPS)
    print(json.dumps({
        "batch": batch_size, "steps": STEPS, "compute_dtype": dtype,
        "finetune": args.finetune, "fused_attn": True, "dropout": 0.1,
        "step_ms_median": statistics.median(step_ms), "step_ms": step_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "card": card}), flush=True)

    summary = P.profile_window(step, 3, KERNELS, TRAIN_GROUPS + P.GROUPS)
    print(json.dumps({"profiled_steps": 3, **summary, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
