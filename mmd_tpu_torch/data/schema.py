"""Factify-2 column schema and project paths (the port's copy of
mmd_tpu/data/schema.py).

Column contract of the reference (reference src/utils/data_utils.py:11-20
HEADERS; its preprocess step renames the raw URL columns to `*_original`
and writes local relative paths into claim_image/evidence_image). The data
tree under the project root is a contract the two packages share, so the
root comes from the same MMD_TPU_ROOT variable.
"""

from __future__ import annotations

import os
from pathlib import Path

HEADERS = [
    "id",
    "claim",
    "claim_image",
    "evidence",
    "evidence_image",
    "category",
    "claim_ocr",
    "evidence_ocr",
]

ENRICHED_COLUMNS = [
    "claim_image_caption",
    "evidence_image_caption",
    "claim_enriched",
    "evidence_enriched",
]


def get_project_root() -> Path:
    """The checkout's root; MMD_TPU_ROOT overrides it (tests, pipelines)."""
    env = os.environ.get("MMD_TPU_ROOT")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent.parent


def raw_dir() -> Path:
    return get_project_root() / "data" / "raw" / "factify"


def preprocessed_dir() -> Path:
    return get_project_root() / "data" / "preprocessed"


def images_dir() -> Path:
    return raw_dir() / "extracted" / "images"


def get_preprocessed_data(dataset: str = "train"):
    """Load a preprocessed split (reference src/utils/data_utils.py:23-38)."""
    import pandas as pd
    csv_path = preprocessed_dir() / f"{dataset}.csv"
    if not csv_path.exists():
        raise FileNotFoundError(
            f"Preprocessed dataset CSV not found: {csv_path}")
    return pd.read_csv(csv_path)


def load_images_for_row(row: dict) -> dict:
    """Attach decoded PIL images for a row's claim/evidence paths, None on
    any failure (reference src/utils/data_utils.py:41-73)."""
    from PIL import Image
    result = dict(row)
    for key in ("claim_image", "evidence_image"):
        path = row.get(key)
        img = None
        if isinstance(path, str) and path and os.path.exists(path):
            try:
                img = Image.open(path).convert("RGB")
            except (OSError, ValueError) as e:
                print(f"Failed to load {key} from {path}: {e}")
        result[key] = img
    return result
