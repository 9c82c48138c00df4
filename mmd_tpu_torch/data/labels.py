"""Factify-2 label ontology as pure functions and static tables
(the port's copy of mmd_tpu/data/labels.py).

The task's 5 categories map to 4-path label vectors over
{0=Support, 1=NEI, 2=Refute}, one label per evidence path
(text-text, text-image, image-text, image-image). Semantics follow the
reference's mapping (reference src/model/dataset.py:24-74) exactly; the
numpy helpers are copies, and `paths_to_category_idx_torch` /
`paths_to_simplified_torch` are the torch twins of the JAX package's
on-device jnp versions.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# Path order is fixed everywhere: (text_text, text_image, image_text, image_image)
PATHS = ("text_text", "text_image", "image_text", "image_image")

# 3-class per-path labels
SUPPORT, NEI, REFUTE = 0, 1, 2
CLASS_NAMES_3 = ("Support", "NEI", "Refute")

CATEGORIES = (
    "Support_Text",
    "Support_Multimodal",
    "Insufficient_Text",
    "Insufficient_Multimodal",
    "Refute",
)

CATEGORY_TO_LABELS = {
    "Support_Text": (0, 1, 1, 1),
    "Support_Multimodal": (0, 0, 0, 0),
    "Insufficient_Text": (1, 1, 1, 1),
    "Insufficient_Multimodal": (1, 1, 1, 0),
    "Refute": (2, 2, 2, 2),
}

LABELS_TO_CATEGORY = {v: k for k, v in CATEGORY_TO_LABELS.items()}

CATEGORY_TO_IDX = {c: i for i, c in enumerate(CATEGORIES)}
IDX_TO_CATEGORY = {i: c for i, c in enumerate(CATEGORIES)}

SIMPLIFIED_CATEGORY_MAPPING = {
    "Support_Text": "Support",
    "Support_Multimodal": "Support",
    "Insufficient_Text": "NEI",
    "Insufficient_Multimodal": "NEI",
    "Refute": "Refute",
}
SIMPLIFIED_CATEGORY_TO_IDX = {"Support": 0, "NEI": 1, "Refute": 2}
SIMPLIFIED_IDX_TO_CATEGORY = {v: k for k, v in SIMPLIFIED_CATEGORY_TO_IDX.items()}

# Static (5, 4) table: row = category idx, col = path, value = 3-class label.
# Gatherable on device: labels = LABEL_TABLE[category_idx].
LABEL_TABLE = np.array(
    [CATEGORY_TO_LABELS[c] for c in CATEGORIES], dtype=np.int32
)

# Static (5,) table: 5-class category idx -> 3-class simplified idx.
SIMPLIFIED_TABLE = np.array(
    [SIMPLIFIED_CATEGORY_TO_IDX[SIMPLIFIED_CATEGORY_MAPPING[c]] for c in CATEGORIES],
    dtype=np.int32,
)

# Unknown category defaults to all-NEI (reference dataset.py:124).
DEFAULT_LABELS = (1, 1, 1, 1)


def category_to_labels(category: str) -> tuple:
    """4-path label vector for a category; unknown -> all-NEI."""
    return CATEGORY_TO_LABELS.get(category, DEFAULT_LABELS)


def labels_to_category(labels: Sequence[int]) -> str | None:
    """Inverse map; None when the pattern matches no category."""
    return LABELS_TO_CATEGORY.get(tuple(int(x) for x in labels))


def convert_to_simplified_category(category_idx: int) -> int:
    """5-class category index -> 3-class {Support, NEI, Refute} index."""
    return int(SIMPLIFIED_TABLE[category_idx])


def categories_to_label_array(categories: Sequence[str]) -> np.ndarray:
    """Vectorized host-side map: list of category strings -> (N, 4) int32."""
    idx = np.array(
        [CATEGORY_TO_IDX.get(c, -1) for c in categories], dtype=np.int32
    )
    out = np.where(
        idx[:, None] >= 0,
        LABEL_TABLE[np.clip(idx, 0, len(CATEGORIES) - 1)],
        np.array(DEFAULT_LABELS, dtype=np.int32)[None, :],
    )
    return out.astype(np.int32)


def paths_to_category_idx_torch(labels):
    """On-device (N, 4) -> (N,) 5-class category idx; unmatched patterns
    map to Insufficient_Text (all-NEI), mirroring the unknown-category
    default."""
    import torch
    table = torch.as_tensor(LABEL_TABLE, device=labels.device)
    eq = (labels[:, None, :].to(table.dtype) == table[None, :, :]).all(-1)
    hit = eq.any(-1)
    idx = torch.argmax(eq.to(torch.int32), -1)     # the first match
    return torch.where(hit, idx, CATEGORY_TO_IDX["Insufficient_Text"]).to(
        torch.int32)


def paths_to_simplified_torch(labels):
    """On-device (N, 4) -> (N,) 3-class {Support, NEI, Refute}."""
    import torch
    cat = paths_to_category_idx_torch(labels)
    table = torch.as_tensor(SIMPLIFIED_TABLE, device=labels.device)
    return table[cat.long()]


def paths_to_category_idx(labels: np.ndarray) -> np.ndarray:
    """(N, 4) per-path labels -> (N,) 5-class category idx, -1 if unmatched.

    Vectorized inverse of LABEL_TABLE used by the unified eval (this
    is the path->category fusion the reference left undefined in
    eval_models.py:92-100)."""
    eq = (labels[:, None, :] == LABEL_TABLE[None, :, :]).all(-1)  # (N, 5)
    hit = eq.any(-1)
    idx = eq.argmax(-1)
    return np.where(hit, idx, -1).astype(np.int32)
