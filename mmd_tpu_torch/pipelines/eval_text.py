"""Text-only model evaluation (counterpart of mmd_tpu/pipelines/eval_text.py;
reference src/experimental/eval_text.py).

Evaluates a `text_only=True` checkpoint over the pre-embedded store's text
columns: 3-class (Support/NEI/Refute, simplified from the 5-way category)
precision/recall/F1 + accuracy + micro-F1 appended to a CSV.

Usage: python -m mmd_tpu_torch.pipelines.eval_text --store <dir>
           --checkpoint <best_model.pt> [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Optional

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data import labels as lb
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.pipelines.eval_models import (
    add_model_flags, model_from_args, store_logits,
)
from mmd_tpu_torch.training import metrics as M


def evaluate_text_only(store: ArrayStore, model_cfg: ModelConfig,
                       fusion_params, batch_size: int = 192,
                       results_csv: Optional[str] = None,
                       device: str | torch.device = "cuda") -> dict:
    if not model_cfg.text_only:
        raise ValueError("evaluate_text_only needs a text_only model")
    logits, path_labels = store_logits(
        store, model_cfg, fusion_params, batch_size, device,
        columns=["claim_text_embeds", "doc_text_embeds", "labels"])
    y_pred = logits[:, 0].argmax(-1)
    cat = lb.paths_to_category_idx(path_labels)
    y_true = np.where(cat >= 0, lb.SIMPLIFIED_TABLE[np.clip(cat, 0, 4)], 1)

    prec, rec, f1, _ = M.precision_recall_f1(y_true, y_pred, 3)
    metrics = {
        "accuracy": M.accuracy(y_true, y_pred),
        "micro_f1": M.f1_score(y_true, y_pred, 3, "micro"),
        "weighted_f1": M.f1_score(y_true, y_pred, 3, "weighted"),
    }
    for c, name in enumerate(lb.CLASS_NAMES_3):
        metrics[f"precision/{name}"] = float(prec[c])
        metrics[f"recall/{name}"] = float(rec[c])
        metrics[f"f1/{name}"] = float(f1[c])

    if results_csv:
        exists = os.path.exists(results_csv)
        row = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
               "n": len(y_true), **metrics}
        with open(results_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row.keys()))
            if not exists:
                w.writeheader()
            w.writerow(row)
    return metrics


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--results_csv", type=str,
                   default="eval_text_results.csv")
    args = p.parse_args(argv)

    cfg, params, device = model_from_args(args, num_classes=3,
                                          text_only=True)
    metrics = evaluate_text_only(ArrayStore(args.store), cfg,
                                 params, args.batch_size,
                                 args.results_csv, device)
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
