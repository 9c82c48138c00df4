"""Losses: per-path cross-entropy summed over the 4 evidence paths
(counterpart of mmd_tpu/training/losses.py).

Matches the reference objective (reference train.py:161-175: one
CrossEntropyLoss per path on labels[:, idx], summed).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mmd_tpu_torch.data.labels import PATHS


def cross_entropy_per_sample(logits: torch.Tensor, labels: torch.Tensor
                             ) -> torch.Tensor:
    """Per-sample softmax cross-entropy; logits (B, C), labels (B,) int.
    Returns (B,) fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; logits (B, C), labels (B,) int."""
    return cross_entropy_per_sample(logits, labels).mean()


def multipath_loss(
    outputs: Tuple[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]],
                   Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]],
    labels: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """Sum CE over the available paths.

    outputs: ((y_t_t, y_t_i), (y_i_t, y_i_i)); labels (B, 4) with path order
    (text_text, text_image, image_text, image_image).
    Returns (total_loss, {path: loss}).
    """
    (y_t_t, y_t_i), (y_i_t, y_i_i) = outputs
    per_path = {}
    total = torch.zeros((), dtype=torch.float32, device=labels.device)
    for idx, (name, y) in enumerate(zip(PATHS, (y_t_t, y_t_i, y_i_t, y_i_i))):
        if y is None:
            continue
        loss = cross_entropy(y, labels[:, idx])
        per_path[name] = loss
        total = total + loss
    return total, per_path


def single_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """factify / text_only modes: one CE over category or 3-class labels."""
    return cross_entropy(logits, labels)
