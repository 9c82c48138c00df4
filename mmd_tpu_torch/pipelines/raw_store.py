"""Raw sample store: token ids and uint8 images, no embeddings (the port's
copy of mmd_tpu/pipelines/raw_store.py).

The reference's non-pre_embed training path stores raw text and transformed
image tensors per sample (reference dataset.py:76-129) and runs the frozen
encoders every step (train.py:134-143). Here, as in the JAX package, the
store keeps token ids (tokenization is deterministic, so it happens once,
at build) and uint8 images; the encoders run inside the train step.
`train.py` builds the store when it is missing, as the reference builds its
h5 lazily (dataset.py:141-146). A build resumes from `cursor.txt`.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import numpy as np
import pandas as pd

from mmd_tpu_torch.data.labels import categories_to_label_array
from mmd_tpu_torch.data.schema import get_project_root
from mmd_tpu_torch.data.store import ArrayStore, ArrayStoreWriter
from mmd_tpu_torch.data.tokenizer import WordPieceTokenizer
from mmd_tpu_torch.ops.image_ops import TRAIN_TRANSFORM, load_images_parallel

# the columns a raw training batch reads
TRAIN_COLUMNS = ["claim_ids", "claim_mask", "doc_ids", "doc_mask",
                 "claim_image", "doc_image", "labels"]


def raw_store_path(csv_path: str) -> str:
    return os.path.splitext(csv_path)[0] + ".store"


def build_raw_store(
    csv_path: str,
    tokenizer: WordPieceTokenizer,
    max_length: int = 512,
    image_size: int = 256,
    batch_size: int = 64,
    io_workers: int = 16,
) -> ArrayStore:
    """Tokenize the csv's claims and evidence and decode its images (paths
    relative to the project root) into the raw store next to it, dropping
    the rows whose images do not both decode. (The JAX package's
    `enriched` captions and explicit store path have no user in the
    port.)"""
    df = pd.read_csv(csv_path)
    root = get_project_root()
    transform = (TRAIN_TRANSFORM if image_size == 256
                 else dataclasses.replace(TRAIN_TRANSFORM, size=image_size))

    store_path = raw_store_path(csv_path)
    writer = ArrayStoreWriter(
        store_path, capacity=len(df),
        columns={
            "id": ((), np.int64),
            "claim_ids": ((max_length,), np.int32),
            "claim_mask": ((max_length,), np.int32),
            "doc_ids": ((max_length,), np.int32),
            "doc_mask": ((max_length,), np.int32),
            "claim_image": ((image_size, image_size, 3), np.uint8),
            "doc_image": ((image_size, image_size, 3), np.uint8),
            "labels": ((4,), np.int32),
        },
    )
    cursor = Path(store_path) / "cursor.txt"
    start = int(cursor.read_text()) if cursor.exists() else 0
    skipped = 0
    for lo in range(start, len(df), batch_size):
        rows = df.iloc[lo:lo + batch_size]
        c_ids, c_mask, _ = tokenizer.encode_batch(
            rows["claim"].fillna("").astype(str).tolist(),
            max_length=max_length)
        d_ids, d_mask, _ = tokenizer.encode_batch(
            rows["evidence"].fillna("").astype(str).tolist(),
            max_length=max_length)

        def paths(col):
            return [(p if os.path.isabs(p) else str(root / p))
                    if isinstance(p, str) and p else None for p in rows[col]]

        c_img, c_ok = load_images_parallel(paths("claim_image"), transform,
                                           io_workers)
        d_img, d_ok = load_images_parallel(paths("evidence_image"), transform,
                                           io_workers)
        # skip-and-count: both images must decode (reference
        # dataset.py:100-110)
        valid = c_ok & d_ok
        skipped += int((~valid).sum())
        idx = np.nonzero(valid)[0]
        if len(idx):
            writer.append_batch({
                "id": rows["id"].to_numpy(np.int64)[idx],
                "claim_ids": c_ids[idx], "claim_mask": c_mask[idx],
                "doc_ids": d_ids[idx], "doc_mask": d_mask[idx],
                "claim_image": c_img[idx], "doc_image": d_img[idx],
                "labels": categories_to_label_array(
                    rows["category"].tolist())[idx],
            })
        cursor.write_text(str(lo + len(rows)))
    writer.finalize()
    print(f"[raw_store] {csv_path}: {writer.count} samples, {skipped} skipped "
          f"-> {store_path}")
    return ArrayStore(store_path)
