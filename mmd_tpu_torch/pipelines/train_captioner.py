"""Train the captioner on (image, caption) pairs (counterpart of
mmd_tpu/pipelines/train_captioner.py).

The reference uses a pretrained BLIP checkpoint it cannot train
(caption.py:10-13). Here the captioner is a trainable model
(models/captioner.caption_loss): feed any CSV with an image-path column
and a caption column (e.g. an enriched CSV, or any captions dataset mapped
to the schema) and this script teacher-forces the decoder. The params save
to <assets>/captioner.pt with captioner_config.json beside it, which the
caption pipeline picks up.

The optimizer is the JAX package's optax.adamw(lr) with optax's defaults
(training/optim.py): betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on
every leaf (not torch.optim.AdamW's default 1e-2). The data order is the
JAX package's: epoch e visits the rows in
np.random.default_rng(e).permutation order, in full batches.

Usage: python -m mmd_tpu_torch.pipelines.train_captioner \\
    --csv data/preprocessed/train_enriched.csv \\
    --image_col claim_image --caption_col claim_image_caption \\
    --epochs 3 [--tiny] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from mmd_tpu_torch.core.checkpoint import save_params
from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.captioner import (
    CAPTIONER_TEST, CaptionerConfig, caption_loss, init_captioner,
)
from mmd_tpu_torch.ops.image_ops import (
    load_images_parallel, normalize_on_device,
)
from mmd_tpu_torch.pipelines.caption import image_transform
from mmd_tpu_torch.training.optim import make_optimizer


def train_step(params, opt: torch.optim.Optimizer, cfg: CaptionerConfig,
               transform, images_uint8: torch.Tensor, ids: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """One AdamW step on caption_loss -> the loss (a tensor on the device;
    reading it waits for the step)."""
    x = normalize_on_device(images_uint8, transform,
                            L.dtype_of(cfg.vit.compute_dtype))
    opt.zero_grad(set_to_none=True)
    loss = caption_loss(params, cfg, x, ids, mask)
    loss.backward()
    for p in params.parameters():
        # a leaf the loss does not reach gets a zero gradient, as under
        # jax.grad, so its weight decay still applies
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    return loss.detach()


def main(argv=None) -> list[float]:
    """Returns the loss of every step."""
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--image_col", default="claim_image")
    p.add_argument("--caption_col", default="claim_image_caption")
    p.add_argument("--assets", default="assets/encoders")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    root = get_project_root()
    df = pd.read_csv(args.csv)
    df = df[df[args.caption_col].notna() & df[args.image_col].notna()]
    print(f"[train_captioner] {len(df)} (image, caption) pairs")

    assets = Path(args.assets)
    tok_path = assets / "tokenizer.json"
    if tok_path.exists():
        tok = WordPieceTokenizer.load(tok_path)
    else:
        tok = WordPieceTokenizer.train(
            df[args.caption_col].astype(str).tolist(), 30000)
        tok_path.parent.mkdir(parents=True, exist_ok=True)
        tok.save(tok_path)

    base = CAPTIONER_TEST if args.tiny else CaptionerConfig()
    cfg = dataclasses.replace(
        base,
        decoder=dataclasses.replace(base.decoder, vocab_size=tok.vocab_size),
        max_caption_len=min(args.max_len, base.decoder.max_position))
    params = init_captioner(torch.Generator().manual_seed(0), cfg).to(device)
    opt = make_optimizer(params, args.lr)
    transform = image_transform(cfg)

    bs = args.batch_size
    max_len = cfg.max_caption_len
    t0 = time.time()
    losses: list[float] = []
    for epoch in range(args.epochs):
        order = np.random.default_rng(epoch).permutation(len(df))
        epoch_losses = []
        for lo in range(0, len(order) - bs + 1, bs):
            rows = df.iloc[order[lo:lo + bs]]
            paths = [(q if os.path.isabs(str(q)) else str(root / str(q)))
                     for q in rows[args.image_col]]
            imgs, ok = load_images_parallel(paths, transform)
            ids, mask, _ = tok.encode_batch(
                rows[args.caption_col].astype(str).tolist(),
                max_length=max_len)
            mask = mask * ok[:, None].astype(np.int32)  # drop failed decodes
            epoch_losses.append(train_step(
                params, opt, cfg, transform,
                torch.from_numpy(imgs).to(device),
                torch.from_numpy(ids).to(device, torch.int64),
                torch.from_numpy(mask).to(device)))
        # one wait for the card an epoch
        losses.extend(torch.stack(epoch_losses).tolist()
                      if epoch_losses else [])
        last = f"{losses[-1]:.4f}" if epoch_losses else "none (no full batch)"
        print(f"[train_captioner] epoch {epoch}: loss {last}")
    save_params(str(assets / "captioner.pt"), params)
    (assets / "captioner_config.json").write_text(
        json.dumps(dataclasses.asdict(cfg)))
    print(f"[train_captioner] {len(losses)} steps in {time.time() - t0:.1f}s "
          f"-> {assets}/captioner.pt")
    return losses


if __name__ == "__main__":
    main()
