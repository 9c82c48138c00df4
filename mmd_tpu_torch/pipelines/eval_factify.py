"""5-way Factify evaluation of a factify-mode checkpoint (counterpart of
mmd_tpu/pipelines/eval_factify.py).

Parity with reference src/experimental/eval_factify.py: standard accuracy,
Refute-weighted (x4) accuracy (:59-83), per-category accuracy (:85-111), and
an optional confusion-matrix PNG (:47-57) when matplotlib is available (a
.txt of the counts beside the requested path when it is not).

Ground-truth 5-way categories derive from the store's 4-path label vectors
via the exact inverse table (data/labels.py).

Usage: python -m mmd_tpu_torch.pipelines.eval_factify --store <dir>
           --checkpoint <best_model.pt> [--confusion_png out.png]
           [--device cuda]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data import labels as lb
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.pipelines.eval_models import (
    add_model_flags, model_from_args, predict_store,
)
from mmd_tpu_torch.training import metrics as M

REFUTE_WEIGHT = 4.0
REFUTE_IDX = lb.CATEGORY_TO_IDX["Refute"]


def write_confusion(cm: np.ndarray, path: str) -> None:
    """The confusion matrix as a PNG, or as <path>.txt without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        np.savetxt(str(path) + ".txt", cm, fmt="%d")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(5), lb.CATEGORIES, rotation=45, ha="right")
    ax.set_yticks(range(5), lb.CATEGORIES)
    for i in range(5):
        for j in range(5):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center")
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def evaluate_factify(store: ArrayStore, model_cfg: ModelConfig, fusion_params,
                     batch_size: int = 192,
                     confusion_png: Optional[str] = None,
                     device: str | torch.device = "cuda") -> dict:
    if not (model_cfg.factify and model_cfg.num_classes == 5):
        raise ValueError("evaluate_factify needs a 5-class factify model")
    preds, path_labels = predict_store(store, model_cfg, fusion_params,
                                       batch_size, device)
    y_pred = preds[:, 0]
    y_true = lb.paths_to_category_idx(path_labels)
    known = y_true >= 0
    y_pred, y_true = y_pred[known], y_true[known]

    metrics = {
        "accuracy": M.accuracy(y_true, y_pred),
        "weighted_accuracy": M.weighted_accuracy(
            y_true, y_pred, {REFUTE_IDX: REFUTE_WEIGHT}),
    }
    per_cat = M.per_category_accuracy(y_true, y_pred, 5)
    for i, cat in enumerate(lb.CATEGORIES):
        metrics[f"accuracy/{cat}"] = float(per_cat[i])
    if confusion_png:
        write_confusion(M.confusion_matrix(y_true, y_pred, 5), confusion_png)
    return metrics


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--confusion_png", type=str, default=None)
    args = p.parse_args(argv)

    cfg, params, device = model_from_args(args, num_classes=5, factify=True)
    metrics = evaluate_factify(ArrayStore(args.store), cfg,
                               params, args.batch_size,
                               args.confusion_png, device)
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
