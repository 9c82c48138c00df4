"""Classification metrics in plain NumPy (sklearn-compatible semantics);
the port's copy of mmd_tpu/training/metrics.py.

Covers every metric the reference defines (SURVEY.md §6): accuracy,
weighted/micro F1, per-class precision/recall/F1, and the Refute-weighted
accuracy of eval_factify.py:59-83. Implemented here so the hot eval loops
have no sklearn dependency; tests cross-check against sklearn.
"""

from __future__ import annotations

import numpy as np


def _confusion_counts(y_true: np.ndarray, y_pred: np.ndarray, num_classes: int):
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((y_pred == c) & (y_true == c))
        fp[c] = np.sum((y_pred == c) & (y_true != c))
        fn[c] = np.sum((y_pred != c) & (y_true == c))
        support[c] = np.sum(y_true == c)
    return tp, fp, fn, support


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.mean(y_true == y_pred)) if len(y_true) else 0.0


def precision_recall_f1(y_true, y_pred, num_classes: int):
    """Per-class (precision, recall, f1, support) arrays."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp, fp, fn, support = _confusion_counts(y_true, y_pred, num_classes)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-12), 0.0)
    return prec, rec, f1, support


def f1_score(y_true, y_pred, num_classes: int, average: str = "weighted"):
    """average in {'weighted', 'micro', 'macro', None}."""
    prec, rec, f1, support = precision_recall_f1(y_true, y_pred, num_classes)
    if average is None:
        return f1
    if average == "weighted":
        total = support.sum()
        return float((f1 * support).sum() / total) if total else 0.0
    if average == "macro":
        return float(f1.mean())
    if average == "micro":
        # single-label multiclass: micro-F1 == accuracy
        return accuracy(y_true, y_pred)
    raise ValueError(average)


def weighted_accuracy(y_true, y_pred, class_weights: dict[int, float]):
    """Per-sample weighted accuracy (reference eval_factify.py:59-83 uses
    Refute x4)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    w = np.array([class_weights.get(int(c), 1.0) for c in y_true])
    if w.sum() == 0:
        return 0.0
    return float((w * (y_true == y_pred)).sum() / w.sum())


def per_category_accuracy(y_true, y_pred, num_classes: int) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    out = np.zeros(num_classes)
    for c in range(num_classes):
        mask = y_true == c
        out[c] = float(np.mean(y_pred[mask] == c)) if mask.any() else 0.0
    return out


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (y_true.astype(int), y_pred.astype(int)), 1)
    return cm


def topk_accuracy(relevant_found: np.ndarray) -> float:
    """Fraction of queries whose relevant item appeared in the top-k list
    (retrieval protocol of reference experiment_image.py:7-12)."""
    relevant_found = np.asarray(relevant_found, dtype=bool)
    return float(relevant_found.mean()) if len(relevant_found) else 0.0
