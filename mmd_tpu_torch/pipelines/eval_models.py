"""Offline classifier evaluation over a pre-embedded store (counterpart of
mmd_tpu/pipelines/eval_models.py).

Parity with reference src/experimental/eval_models.py: per-path accuracy +
micro-F1 + per-class P/R/F1 appended to a timestamped CSV (:108-122), plus a
UNIFIED row. The reference's unified (non-factify) branch calls functions
that don't exist anywhere (:92-100); as in the JAX package, per-path labels
map to a final 3-class verdict through the demo's two-stage agreement rule
(inference/rules.py), for predictions and ground truth alike.

The forward is `fusion_forward(deterministic=True)` under inference_mode,
one store batch at a time (the ragged tail padded, its `_pad_mask` rows
dropped); logits come back to the host as float32 and the argmax is taken
there, as the JAX package does.

Usage: python -m mmd_tpu_torch.pipelines.eval_models --store <dir>
           --checkpoint <best_model.pt> [--factify] [--batch_size 192]
           [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Mapping, Optional

import numpy as np
import torch

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.data.labels import PATHS
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.inference.predictor import (
    read_fusion_checkpoint, resolve_device,
)
from mmd_tpu_torch.inference.rules import get_final_classification
from mmd_tpu_torch.models.fusion import fusion_forward, init_fusion_params
from mmd_tpu_torch.training import metrics as M

IDX_TO_LABEL = {0: "support", 1: "not_enough_information", 2: "refute"}
LABEL_TO_IDX = {v: k for k, v in IDX_TO_LABEL.items()}


def fusion_module(params, model_cfg: ModelConfig,
                  device: torch.device) -> torch.nn.Module:
    """The fusion params on `device`: a ParamTree (moved there), or a state
    dict loaded into the seeded tree of `model_cfg`."""
    if isinstance(params, Mapping):
        tree = init_fusion_params(torch.Generator().manual_seed(0),
                                  model_cfg)
        tree.load_state_dict(params)
        params = tree
    return params.to(device)


def _batch_logits(params, model_cfg: ModelConfig, batch: dict,
                  device: torch.device) -> np.ndarray:
    """One store batch -> (B, P, C) float32 logits on the host."""
    def dev(name):
        return (None if name not in batch
                else torch.tensor(batch[name], device=device))

    with torch.inference_mode():
        out = fusion_forward(params, model_cfg,
                             X_t=dev("claim_text_embeds"),
                             X_i=dev("claim_image_embeds"),
                             E_t=dev("doc_text_embeds"),
                             E_i=dev("doc_image_embeds"),
                             deterministic=True)
        if model_cfg.factify or model_cfg.text_only:
            logits = out[0][:, None, :]
        else:
            (y_tt, y_ti), (y_it, y_ii) = out
            logits = torch.stack([y_tt, y_ti, y_it, y_ii], dim=1)
        return logits.float().cpu().numpy()


def store_logits(store: ArrayStore, model_cfg: ModelConfig, fusion_params,
                 batch_size: int = 192, device: str | torch.device = "cuda",
                 columns=None):
    """-> (logits (N, P, C) float32, labels (N, 4) int) over the store's
    rows, in order; P = 4 multipath or 1."""
    device = resolve_device(device)
    params = fusion_module(fusion_params, model_cfg, device)
    logits, labels = [], []
    for batch in store.batches(batch_size, drop_last=False,
                               columns=columns):
        mask = batch.pop("_pad_mask", None)
        lg = _batch_logits(params, model_cfg, batch, device)
        lb = batch["labels"]
        if mask is not None:
            lg, lb = lg[mask], lb[mask]
        logits.append(lg)
        labels.append(lb)
    return np.concatenate(logits), np.concatenate(labels)


def predict_store(store: ArrayStore, model_cfg: ModelConfig, fusion_params,
                  batch_size: int = 192,
                  device: str | torch.device = "cuda"):
    """-> (preds (N, P), labels (N, P)) int arrays; P=4 multipath or 1."""
    logits, labels = store_logits(store, model_cfg, fusion_params,
                                  batch_size, device)
    return logits.argmax(-1), labels


def unified_from_paths(path_preds: np.ndarray) -> np.ndarray:
    """(N, 4) per-path 3-class -> (N,) unified 3-class via agreement rule."""
    out = np.empty(len(path_preds), np.int32)
    for i, row in enumerate(path_preds):
        labels = [IDX_TO_LABEL[int(x)] for x in row]
        out[i] = LABEL_TO_IDX[get_final_classification(labels)]
    return out


def evaluate_store(store: ArrayStore, model_cfg: ModelConfig, fusion_params,
                   batch_size: int = 192, results_csv: Optional[str] = None,
                   num_classes: int = 3,
                   device: str | torch.device = "cuda") -> dict:
    preds, labels = predict_store(store, model_cfg, fusion_params,
                                  batch_size, device)
    return metrics_from_preds(preds, labels, results_csv=results_csv,
                              num_classes=num_classes)


def metrics_from_preds(preds: np.ndarray, labels: np.ndarray,
                       results_csv: Optional[str] = None,
                       num_classes: int = 3) -> dict:
    """(N, P) preds/labels -> per-path + unified metric rows (+CSV append)."""
    rows = []
    metrics: dict = {}

    def add_row(name, y_pred, y_true, ncls):
        acc = M.accuracy(y_true, y_pred)
        micro = M.f1_score(y_true, y_pred, ncls, "micro")
        weighted = M.f1_score(y_true, y_pred, ncls, "weighted")
        prec, rec, f1, _ = M.precision_recall_f1(y_true, y_pred, ncls)
        metrics[f"{name}/accuracy"] = acc
        metrics[f"{name}/micro_f1"] = micro
        metrics[f"{name}/weighted_f1"] = weighted
        row = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
               "path": name, "accuracy": acc, "micro_f1": micro,
               "weighted_f1": weighted, "n": len(y_true)}
        for c in range(ncls):
            row[f"class{c}_precision"] = prec[c]
            row[f"class{c}_recall"] = rec[c]
            row[f"class{c}_f1"] = f1[c]
        rows.append(row)

    if preds.shape[1] == 4:
        for p_idx, name in enumerate(PATHS):
            add_row(name, preds[:, p_idx], labels[:, p_idx], num_classes)
        add_row("unified", unified_from_paths(preds),
                unified_from_paths(labels), 3)
    else:
        add_row("unified", preds[:, 0], labels[:, 0], num_classes)

    if results_csv:
        os.makedirs(os.path.dirname(results_csv) or ".", exist_ok=True)
        exists = os.path.exists(results_csv)
        with open(results_csv, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            if not exists:
                w.writeheader()
            w.writerows(rows)
    return metrics


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The eval CLIs' shared flags: the store, a checkpoint (a
    save_params file such as the trainer's best_model.pt; none gives the
    seeded init), the batch, the fusion model's widths and the device."""
    p.add_argument("--store", required=True)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=192)
    p.add_argument("--text_input_dim", type=int, default=384)
    p.add_argument("--image_input_dim", type=int, default=1024)
    p.add_argument("--embed_dim", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--hidden_dim", type=int, default=64)
    p.add_argument("--device", type=str, default="cuda")


def model_from_args(args, **mode) -> tuple[ModelConfig, object,
                                           torch.device]:
    """(config, params, device) of the shared flags: the checkpoint's state
    dict, or the seeded init without one. The attention takes the kernel
    on the card (ops/attention.py's routing rule decides), the explicit
    path on the CPU."""
    device = resolve_device(args.device)
    cfg = ModelConfig(
        text_input_dim=args.text_input_dim,
        image_input_dim=args.image_input_dim, embed_dim=args.embed_dim,
        num_heads=args.num_heads, hidden_dim=args.hidden_dim,
        fused_attn=device.type == "cuda", **mode)
    params = (read_fusion_checkpoint(args.checkpoint) if args.checkpoint
              else init_fusion_params(torch.Generator().manual_seed(0), cfg))
    return cfg, params, device


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    add_model_flags(p)
    p.add_argument("--factify", action="store_true")
    p.add_argument("--num_classes", type=int, default=3)
    p.add_argument("--results_csv", type=str, default="eval_results.csv")
    args = p.parse_args(argv)

    cfg, params, device = model_from_args(
        args, num_classes=args.num_classes, factify=args.factify)
    metrics = evaluate_store(ArrayStore(args.store), cfg, params,
                             args.batch_size, args.results_csv,
                             args.num_classes, device)
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
