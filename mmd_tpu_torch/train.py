"""Train the misinformation fusion model with PyTorch on one device
(counterpart of the repository's train.py).

    python -m mmd_tpu_torch.train --pre_embed --train_data data/preprocessed/train.csv \\
        --epochs 50 --batch_size 32 --lr 1e-4 --fused_attn \\
        [--val_data ... --validate_every_epoch --save_best] [--device cuda|cpu]
    python -m mmd_tpu_torch.train --synthetic_samples 2048 --batch_size 256 \\
        --fused_attn [--compute_dtype float32]
    python -m mmd_tpu_torch.train --train_data data/preprocessed/train.csv \\
        --batch_size 8 --fused_attn [--finetune_encoders] [--remat]

--compute_dtype defaults to bfloat16, as in the JAX package: with dropout on
the card the MLPs then run the fused GELU-MLP kernels (ops/mlp.py); on the
CPU, and in float32, they run unfused.

CLI contract of the JAX package's train.py (reference train.py:24-85):
  * --pre_embed reads the ArrayStore the embed pipeline wrote next to the
    csv (<base>_embeddings.store), as the JAX package does;
  * without --pre_embed or --synthetic_samples, the raw path: the frozen
    encoders (models/frozen.py: seeded, with the tokenizer under
    assets/encoders, trained on the csv's texts at first use) run inside
    the step on token ids and uint8 images from the raw store next to the
    csv (<base>.store, built at first use by pipelines/raw_store.py, image
    paths relative to MMD_TPU_ROOT); --finetune_encoders trains them with
    the fusion model;
  * --synthetic_samples N trains on N synthetic pre-embedded samples (smoke
    runs); with --validate_every_epoch the port also draws N // 4
    held-out synthetic samples to validate on (the JAX CLI validates only
    on stores);
  * checkpoints are torch.save files under <output_dir>/checkpoints and
    RESUMABLE (--resume_from <output_dir>/checkpoints);
  * metrics go to <output_dir>/metrics.jsonl always, wandb only if --wandb;
  * --device cuda (the default) raises where there is no card; the CPU is
    used only when asked for.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    from mmd_tpu_torch.core.config import add_train_flags
    p = argparse.ArgumentParser(
        description="Train misinformation detection model")
    add_train_flags(p)
    p.add_argument("--wandb", action="store_true", help="also log to wandb")
    p.add_argument("--synthetic_samples", type=int, default=0,
                   help="train on N synthetic pre-embedded samples (smoke "
                        "runs)")
    return p.parse_args(argv)


def store_path_for_csv(csv_path: str, pre_embed: bool) -> str:
    """Derive the store dir from the csv path (reference dataset.py:137-139
    derives {base}.h5 / {base}_embeddings.h5 the same way)."""
    base = os.path.splitext(csv_path)[0]
    return base + ("_embeddings.store" if pre_embed else ".store")


def build(args):
    """(cfg, trainer, train_batches, val_batches) for parsed arguments: the
    set-up `main` runs before `run_training`."""
    from mmd_tpu_torch.core.config import train_config_from_args
    from mmd_tpu_torch.data.store import ArrayStore
    from mmd_tpu_torch.data.synthetic import synthetic_preembed_batch
    from mmd_tpu_torch.training.trainer import Trainer

    cfg = train_config_from_args(args)
    val_batches = None
    if args.synthetic_samples:
        trainer = Trainer(cfg, device=args.device)
        rng = np.random.default_rng(cfg.seed)
        n_batches = max(1, args.synthetic_samples // cfg.batch_size)
        data = [synthetic_preembed_batch(rng, cfg.batch_size)
                for _ in range(n_batches)]

        def train_batches(epoch):
            return iter(data)
        if cfg.validate_every_epoch:
            n_val = max(1, n_batches // 4)
            val = [synthetic_preembed_batch(rng, cfg.batch_size)
                   for _ in range(n_val)]

            def val_batches():
                return iter([dict(b) for b in val])
    elif cfg.data.pre_embed:
        trainer = Trainer(cfg, device=args.device)
        store = ArrayStore(store_path_for_csv(cfg.data.train_data, True))
        print(f"[train] {len(store)} pre-embedded samples")

        def train_batches(epoch):
            return store.batches(cfg.batch_size, shuffle=cfg.data.shuffle,
                                 seed=cfg.seed + epoch, drop_last=True)

        if cfg.data.val_data:
            val_store = ArrayStore(store_path_for_csv(cfg.data.val_data,
                                                      True))

            def val_batches():
                return val_store.batches(cfg.batch_size, drop_last=False)
    else:
        # the raw path (the reference's default): the encoders run inside
        # the step; the raw store builds at first use, as the reference's
        # h5 does (dataset.py:141-146)
        import pandas as pd

        from mmd_tpu_torch.models.frozen import load_or_init_frozen
        from mmd_tpu_torch.pipelines.raw_store import (
            TRAIN_COLUMNS, build_raw_store, raw_store_path,
        )

        df = pd.read_csv(cfg.data.train_data)
        texts = (df["claim"].fillna("").astype(str).tolist()
                 + df["evidence"].fillna("").astype(str).tolist())
        enc = load_or_init_frozen("assets/encoders", vocab_texts=texts)
        sp = raw_store_path(cfg.data.train_data)
        if not os.path.exists(os.path.join(sp, "meta.json")):
            print(f"[train] raw store not found at {sp}; building...")
        store = build_raw_store(cfg.data.train_data, enc.tokenizer)
        print(f"[train] {len(store)} raw samples (on-the-fly encoding)")
        trainer = Trainer(cfg, device=args.device, encoders=enc,
                          finetune=args.finetune_encoders)

        def train_batches(epoch):
            return store.batches(cfg.batch_size, shuffle=cfg.data.shuffle,
                                 seed=cfg.seed + epoch, drop_last=True,
                                 columns=TRAIN_COLUMNS)
    return cfg, trainer, train_batches, val_batches


def main(argv=None):
    from mmd_tpu_torch.training.loop import run_training

    args = parse_args(argv)
    cfg, trainer, train_batches, val_batches = build(args)
    print(f"[train] device {trainer.device}, {cfg.model.compute_dtype}, "
          f"fused_attn={cfg.model.fused_attn}, dropout {cfg.model.dropout}")
    state = run_training(trainer, train_batches, val_batches,
                         use_wandb=args.wandb)
    print(f"[train] done at step {state.step}")
    return state


if __name__ == "__main__":
    main()
