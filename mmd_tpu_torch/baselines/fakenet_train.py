"""FakeNet training, evaluation and ensemble (counterpart of
mmd_tpu/baselines/fakenet_train.py).

Parity with the vendored Pre-CoFactv2 scripts: AdamW with linear warmup
(reference src/baselines/Pre-CoFactv2/train.py:150-155), weighted-F1-gated
best-checkpointing (:346-360), test-set prediction to an answer CSV with
per-class probabilities (evaluate.py), and the 3-model weighted-power
ensemble grid search over w in {0..1}, p in {1/8..2} (ensemble.py:36-96).

The optimizer is optax.adamw over the warmup-linear schedule with optax's
defaults (training/optim.make_optimizer), the schedule's value at
the update's count set as the learning rate before each update. The params
are updated in place, so the best epoch's params are kept as a copy.

Data: pre-embedded ArrayStore with a 5-class `category` column and a 32-d
`add_feature` column (OCR stats in the original; zeros when absent).

Usage: python -m mmd_tpu_torch.baselines.fakenet_train --store <dir> \\
    [--epochs 15] [--batch_size 24] [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import csv
import itertools
import json
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from mmd_tpu_torch.baselines.fakenet import (
    FakeNetConfig, fakenet_forward, init_fakenet,
)
from mmd_tpu_torch.data import labels as lb
from mmd_tpu_torch.data.store import ArrayStore
from mmd_tpu_torch.inference.predictor import resolve_device
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.training import metrics as M
from mmd_tpu_torch.training.losses import cross_entropy
from mmd_tpu_torch.training.optim import make_optimizer

INPUTS = ("claim_text_embeds", "claim_image_embeds", "doc_text_embeds",
          "doc_image_embeds", "add_feature")


def _inputs(batch: dict, device) -> list[torch.Tensor]:
    return [torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in INPUTS]


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of training step `step` (the JAX package folds the
    step into key(seed + 1))."""
    return D.split_seed(((seed + 1) << 32) + step, 1)[0]


def warmup_linear_schedule(lr: float, warmup_steps: int, total_steps: int
                           ) -> Callable[[int], float]:
    """optax.join_schedules of linear_schedule(0, lr, warmup) and
    linear_schedule(lr, 0, total - warmup) at boundary warmup, in float32
    as optax computes it."""
    def linear(init: float, end: float, steps: int, count: int):
        count = np.float32(min(max(count, 0), steps))
        frac = np.float32(1) - count / np.float32(steps)
        return np.float32(init - end) * frac + np.float32(end)

    warm, rest = max(warmup_steps, 1), max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return float(linear(0.0, lr, warm, step))
        return float(linear(lr, 0.0, rest, step - warmup_steps))
    return schedule


def make_fakenet_train_step(cfg: FakeNetConfig, params: torch.nn.Module,
                            optimizer: torch.optim.Optimizer,
                            schedule: Callable[[int], float]):
    """-> step(batch, seed) -> (loss, predictions), both on the device: one
    AdamW update of `params` in place on the cross-entropy of the training
    forward (dropout on, every site's seed split from `seed`)."""
    count = itertools.count()

    def step(batch: dict, seed: int):
        device = next(params.parameters()).device
        lr = schedule(next(count))
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.zero_grad(set_to_none=True)
        logits, _ = fakenet_forward(params, cfg, *_inputs(batch, device),
                                    seed=seed, deterministic=False)
        loss = cross_entropy(logits, torch.as_tensor(
            np.asarray(batch["category"])).to(device))
        loss.backward()
        for p in params.parameters():
            # a leaf the loss does not reach gets a zero gradient, as under
            # jax.grad, so its weight decay still applies
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.detach(), logits.detach().argmax(-1)

    return step


def train_fakenet(cfg: FakeNetConfig, batches_per_epoch, epochs: int = 15,
                  lr: float = 5e-5, warmup_steps: int = 100,
                  val_batches=None, seed: int = 42, device="cuda"):
    """batches_per_epoch(epoch) -> iterable of batch dicts (numpy). Returns
    (best_params, history). Best = highest weighted F1 on val (or train);
    best_params is a copy of the params after that epoch."""
    device = resolve_device(device)
    total = epochs * 100  # schedule horizon estimate; harmless if off
    params = init_fakenet(torch.Generator().manual_seed(seed), cfg).to(device)
    optimizer = make_optimizer(params, lr)
    step_fn = make_fakenet_train_step(
        cfg, params, optimizer, warmup_linear_schedule(lr, warmup_steps,
                                                       total))

    best_f1, best_params = -1.0, params
    history = []
    step_i = 0
    for epoch in range(epochs):
        preds, labels, loss = [], [], None
        for batch in batches_per_epoch(epoch):
            loss, pred = step_fn(batch, step_seed(seed, step_i))
            preds.append(pred.cpu().numpy())
            labels.append(np.asarray(batch["category"]))
            step_i += 1
        y_pred, y_true = np.concatenate(preds), np.concatenate(labels)
        if val_batches is not None:
            y_pred, y_true = predict_fakenet(params, cfg, val_batches())
        f1 = M.f1_score(y_true, y_pred, cfg.num_classes, "weighted")
        history.append({"epoch": epoch, "loss": float(loss),
                        "weighted_f1": f1})
        if f1 > best_f1:
            best_f1, best_params = f1, copy.deepcopy(params)
    return best_params, history


def predict_fakenet(params: torch.nn.Module, cfg: FakeNetConfig,
                    batches: Iterable[dict], return_probs: bool = False):
    """Deterministic forward over `batches` on the params' device ->
    (y_pred, y_true or None[, probs])."""
    device = next(params.parameters()).device
    preds, labels, probs = [], [], []
    with torch.inference_mode():
        for batch in batches:
            logits, _ = fakenet_forward(params, cfg, *_inputs(batch, device))
            logits = logits.float().cpu().numpy()
            preds.append(logits.argmax(-1))
            probs.append(_softmax(logits))
            if "category" in batch:
                labels.append(np.asarray(batch["category"]))
    y_pred = np.concatenate(preds)
    y_true = np.concatenate(labels) if labels else None
    if return_probs:
        return y_pred, y_true, np.concatenate(probs)
    return y_pred, y_true


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def ensemble_grid_search(prob_sets: Sequence[np.ndarray], y_true: np.ndarray,
                         weights: Sequence[float] = (0, 0.25, 0.5, 0.75, 1.0),
                         powers: Sequence[float] = (0.125, 0.25, 0.5, 1.0, 2.0)):
    """Weighted-power ensemble of per-model probability matrices
    (reference ensemble.py:36-96): score = sum_i w_i * probs_i ** p, maximize
    weighted F1 over the (w_1..w_n, p) grid. Returns (best_config, best_f1)."""
    n = len(prob_sets)
    best = (None, -1.0)
    for ws in itertools.product(weights, repeat=n):
        if not any(ws):
            continue
        for p in powers:
            mix = sum(w * probs ** p for w, probs in zip(ws, prob_sets))
            f1 = M.f1_score(y_true, np.argmax(mix, -1),
                            prob_sets[0].shape[1], "weighted")
            if f1 > best[1]:
                best = ({"weights": ws, "power": p}, f1)
    return best


COLUMNS = ["claim_text_embeds", "doc_text_embeds", "claim_image_embeds",
           "doc_image_embeds", "labels"]


def main(argv=None) -> dict:
    """CLI: train/evaluate FakeNet over a pre-embedded ArrayStore with a
    per-path `labels` column (vendored Pre-CoFactv2 train.py/evaluate.py
    equivalents). Returns {"params", "history", "y_pred", "y_true",
    "probs", "weighted_f1"}."""
    p = argparse.ArgumentParser()
    p.add_argument("--store", required=True)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch_size", type=int, default=24)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--text_dim", type=int, default=384)
    p.add_argument("--image_dim", type=int, default=1024)
    p.add_argument("--hidden_dim", type=int, default=256)
    p.add_argument("--head", type=int, default=2)
    p.add_argument("--answer_csv", type=str, default="answer_fakenet.csv")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    store = ArrayStore(args.store)
    cfg = FakeNetConfig(text_dim=args.text_dim, image_dim=args.image_dim,
                        hidden_dim=args.hidden_dim, head=args.head)

    def add_columns(batch):
        batch = dict(batch)
        cat = lb.paths_to_category_idx(batch["labels"])
        batch["category"] = np.where(cat >= 0, cat, 2).astype(np.int32)
        n = len(batch["category"])
        batch["add_feature"] = np.zeros((n, cfg.add_feature_dim), np.float32)
        return batch

    def batches(epoch):
        for b in store.batches(args.batch_size, shuffle=True, seed=epoch,
                               columns=COLUMNS):
            yield add_columns(b)

    params, history = train_fakenet(cfg, batches, epochs=args.epochs,
                                    lr=args.lr, device=device)
    print(json.dumps(history[-1], indent=1))

    def eval_batches():
        for b in store.batches(args.batch_size, columns=COLUMNS):
            yield add_columns(b)

    y_pred, y_true, probs = predict_fakenet(params, cfg, eval_batches(),
                                            return_probs=True)
    with open(args.answer_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "pred"] + [f"p{i}" for i in range(cfg.num_classes)])
        for i, (pr, row) in enumerate(zip(y_pred, probs)):
            w.writerow([i, int(pr)] + [f"{x:.5f}" for x in row])
    f1 = M.f1_score(y_true, y_pred, cfg.num_classes, "weighted")
    print(f"weighted F1 on store: {f1:.4f}; answers -> {args.answer_csv}")
    return {"params": params, "history": history, "y_pred": y_pred,
            "y_true": y_true, "probs": probs, "weighted_f1": f1}


if __name__ == "__main__":
    main()
