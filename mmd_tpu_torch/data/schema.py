"""Factify-2 column schema and the project root (the port's copy of
mmd_tpu/data/schema.py's HEADERS and get_project_root).

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


def get_project_root() -> Path:
    """The checkout's root; MMD_TPU_ROOT overrides it (tests, pipelines)."""
    env = os.environ.get("MMD_TPU_ROOT")
    if env:
        return Path(env)
    return Path(__file__).resolve().parent.parent.parent
