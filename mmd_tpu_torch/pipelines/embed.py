"""Stage 3: batch-embed the preprocessed CSV through the frozen encoders
(counterpart of mmd_tpu/pipelines/embed.py).

Parity with reference src/data_loader/preprocess_embeddings.py: every valid
sample (both images present -- skip-and-count otherwise, reference
dataset.py:100-110) gets claim/doc text embeddings (512, text_dim) and
claim/doc image embeddings (num_tokens, image_dim), written to an
ArrayStore at `{csv_base}_embeddings.store` in the JAX package's format.
Shapes are checked as the reference checks them
(preprocess_embeddings.py:83-88).

Each batch has one shape: the ragged tail is padded to `batch_size` with
empty texts and missing images, whose rows are never written. The host
tokenizes and decodes images into uint8 (a fresh array each batch); the
device normalizes them, runs the four encodes under inference_mode and
casts the outputs to float16 before the copy back (half the bytes of an
fp32 encoder's output). The JAX package casts on the host; both round to
nearest even. Batch i's encodes are enqueued before batch i+1's host work
and pulled back after it.

Resume: the CSV row cursor lives in the store's meta.json (`csv_cursor`)
and is written in the same atomic rename as the sample count; a legacy
cursor.txt is honored.

Usage: python -m mmd_tpu_torch.pipelines.embed --csv data/preprocessed/train.csv
           [--enriched] [--batch_size 64] [--tiny] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from mmd_tpu_torch.core.profiling import Stages
from mmd_tpu_torch.data.labels import categories_to_label_array
from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.data.store import ArrayStore, ArrayStoreWriter
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.frozen import (
    FrozenEncoders, image_encode, load_or_init_frozen, text_encode,
)
from mmd_tpu_torch.ops.image_ops import (
    TRAIN_TRANSFORM, load_images_parallel, normalize_on_device,
)


def store_path_for_csv(csv_path: str) -> str:
    return os.path.splitext(csv_path)[0] + "_embeddings.store"


def encode_batch(enc: FrozenEncoders, c_ids, c_mask, d_ids, d_mask,
                 c_u8, d_u8) -> tuple:
    """The four encodes of one batch on the encoders' device: claim and
    document texts ((B, T) ids and masks), claim and document images
    ((B, S, S, 3) uint8) -> four float16 device tensors, (B, T, text_dim)
    and (B, num_tokens, image_dim)."""
    dt = L.dtype_of(enc.vit_cfg.compute_dtype)
    with torch.inference_mode():
        outs = (
            text_encode(enc.text_params, enc.text_cfg, c_ids, c_mask),
            text_encode(enc.text_params, enc.text_cfg, d_ids, d_mask),
            image_encode(enc.vit_params, enc.vit_cfg,
                         normalize_on_device(c_u8, TRAIN_TRANSFORM, dt)),
            image_encode(enc.vit_params, enc.vit_cfg,
                         normalize_on_device(d_u8, TRAIN_TRANSFORM, dt)),
        )
        return tuple(o.to(torch.float16) for o in outs)


def embed_csv(
    csv_path: str,
    enc: FrozenEncoders,
    enriched: bool = False,
    batch_size: int = 64,
    max_length: int = 512,
    store_path: str | None = None,
    io_workers: int = 16,
    device: str | torch.device = "cuda",
) -> ArrayStore:
    """Embed the CSV's rows into the store (resuming at its cursor) and
    return the store. The encoders are moved to `device`."""
    device = resolve_device(device)
    for tree in (enc.text_params, enc.vit_params):
        tree.to(device).requires_grad_(False)
    df = pd.read_csv(csv_path)
    claim_col = "claim_enriched" if enriched else "claim"
    doc_col = "evidence_enriched" if enriched else "evidence"

    text_dim = enc.text_cfg.hidden_size
    img_tokens = enc.vit_cfg.num_tokens
    img_dim = enc.vit_cfg.hidden_size
    root = get_project_root()

    store_path = store_path or store_path_for_csv(csv_path)
    writer = ArrayStoreWriter(
        store_path, capacity=len(df),
        columns={
            "id": ((), np.int64),
            "claim_text_embeds": ((max_length, text_dim), np.float16),
            "doc_text_embeds": ((max_length, text_dim), np.float16),
            "claim_image_embeds": ((img_tokens, img_dim), np.float16),
            "doc_image_embeds": ((img_tokens, img_dim), np.float16),
            "labels": ((4,), np.int32),
        },
    )
    legacy_cursor = Path(store_path) / "cursor.txt"
    start_row = int(writer.extra.get(
        "csv_cursor",
        int(legacy_cursor.read_text()) if legacy_cursor.exists() else 0))
    skipped = 0
    t0 = time.time()
    stages = Stages()

    size = enc.vit_cfg.image_size
    transform = (TRAIN_TRANSFORM if size == TRAIN_TRANSFORM.size
                 else dataclasses.replace(TRAIN_TRANSFORM, size=size))

    def prep(lo):
        """Host work for one batch: tokenize, decode images, and copy both
        to the card (torch.tensor copies: nothing aliases a host buffer)."""
        rows = df.iloc[lo:lo + batch_size]
        n = len(rows)

        def pad(texts):
            return list(texts) + [""] * (batch_size - n)

        with stages.stage("tokenize", log=False):
            c_ids, c_mask, _ = enc.tokenizer.encode_batch(
                pad(rows[claim_col].fillna("").astype(str)),
                max_length=max_length)
            d_ids, d_mask, _ = enc.tokenizer.encode_batch(
                pad(rows[doc_col].fillna("").astype(str)),
                max_length=max_length)

        def paths(col):
            out = []
            for p in rows[col]:
                if isinstance(p, str) and p:
                    out.append(p if os.path.isabs(p) else str(root / p))
                else:
                    out.append(None)
            return out + [None] * (batch_size - n)

        with stages.stage("image_decode", log=False):
            c_imgs, c_ok = load_images_parallel(paths("claim_image"),
                                                transform, io_workers)
            d_imgs, d_ok = load_images_parallel(paths("evidence_image"),
                                                transform, io_workers)
        host = tuple(
            torch.tensor(a, dtype=dtype, device=device)
            for a, dtype in ((c_ids, torch.long), (c_mask, torch.int32),
                             (d_ids, torch.long), (d_mask, torch.int32),
                             (c_imgs, torch.uint8), (d_imgs, torch.uint8)))
        return lo, rows, n, c_ok[:n] & d_ok[:n], host

    def write_out(lo, rows, n, valid, outs):
        """Pull one batch's embeddings to the host and append the valid
        rows to the store."""
        nonlocal skipped
        with stages.stage("d2h_store", log=False):
            ct, dt, ci, di = (o.cpu().numpy() for o in outs)
        if ct.shape != (batch_size, max_length, text_dim) or \
                ci.shape != (batch_size, img_tokens, img_dim):
            raise RuntimeError(f"encoder output shapes {ct.shape}, "
                               f"{ci.shape}")
        skipped += int((~valid).sum())
        if valid.any():
            idx = np.nonzero(valid)[0]
            writer.append_batch({
                "id": rows["id"].to_numpy(np.int64)[idx],
                "claim_text_embeds": ct[idx],
                "doc_text_embeds": dt[idx],
                "claim_image_embeds": ci[idx],
                "doc_image_embeds": di[idx],
                "labels": categories_to_label_array(
                    rows["category"].tolist())[idx],
            }, extra={"csv_cursor": lo + n})
        else:
            writer.update_extra(csv_cursor=lo + n)

    # one-deep software pipeline: batch i's encodes are enqueued on the
    # card, the host preps batch i+1, and only then are batch i's results
    # pulled back, so the card's work hides behind the host's
    pending = None
    for lo in range(start_row, len(df), batch_size):
        lo_p, rows_p, n_p, valid_p, host = prep(lo)
        with stages.stage("encode_dispatch", log=False):
            outs = encode_batch(enc, *host)
        if pending is not None:
            write_out(*pending)
        pending = (lo_p, rows_p, n_p, valid_p, outs)
    if pending is not None:
        write_out(*pending)

    writer.finalize()
    dt_s = time.time() - t0
    print(f"[embed] {csv_path}: {writer.count} samples embedded, {skipped} "
          f"skipped (missing images), {dt_s:.1f}s "
          f"({(len(df) - start_row) / max(dt_s, 1e-9):.1f} rows/s) -> "
          f"{store_path}")
    print("[embed] " + stages.report().replace("\n", "\n[embed] "))
    return ArrayStore(store_path)


def main(argv=None) -> ArrayStore:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", required=True)
    p.add_argument("--enriched", action="store_true")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--assets", type=str, default="assets/encoders")
    p.add_argument("--tiny", action="store_true",
                   help="tiny encoder configs (tests/smoke)")
    p.add_argument("--store", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    df = pd.read_csv(args.csv)
    texts = (df["claim"].fillna("").astype(str).tolist()
             + df["evidence"].fillna("").astype(str).tolist())
    enc = load_or_init_frozen(args.assets, vocab_texts=texts, tiny=args.tiny)
    return embed_csv(args.csv, enc, enriched=args.enriched,
                     batch_size=args.batch_size, store_path=args.store,
                     device=device)


if __name__ == "__main__":
    main()
