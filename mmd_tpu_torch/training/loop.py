"""The training loop (counterpart of mmd_tpu/training/loop.py): epochs
over an ArrayStore (or any batch iterable), metric accumulation, periodic
checkpoints, per-epoch validation, best-model tracking. Functional parity
with reference train.py:109-246,388-434.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from mmd_tpu_torch.core.checkpoint import CheckpointManager, save_params
from mmd_tpu_torch.core.metrics import MetricsLogger
from mmd_tpu_torch.data.labels import PATHS
from mmd_tpu_torch.training import metrics as M
from mmd_tpu_torch.training.trainer import Trainer, TrainState


def prefetch_to_device(batches: Iterable[dict], device,
                       depth: int) -> Iterable[dict]:
    """Keep `depth` batches' host-to-device copies in flight ahead of
    consumption.

    On a CUDA device each batch is copied into a FRESH pinned staging
    buffer, never one still being read by an in-flight copy (the aliasing
    fault the JAX package fixed in 1cda9f1): PyTorch's pinned-memory cache
    hands a freed buffer out again only after the copies that read it have
    finished. The copies run non_blocking on a side stream; an event
    recorded after them makes the consuming stream wait for exactly that
    batch, and the device tensors are marked as used by it. Numerics-
    neutral: batches come out in order. Elsewhere, or at depth 0, each
    batch is copied at use."""
    device = torch.device(device)
    if depth <= 0 or device.type != "cuda":
        for b in batches:
            yield {k: torch.tensor(np.asarray(v)).to(device)
                   for k, v in b.items()}
        return
    stream = torch.cuda.Stream(device)
    queue: deque = deque()

    def ready(item):
        dev, event = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for t in dev.values():
            t.record_stream(consumer)
        return dev

    for b in batches:
        staged = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                  for k, v in b.items()}
        with torch.cuda.stream(stream):
            dev = {k: t.to(device, non_blocking=True)
                   for k, t in staged.items()}
            event = torch.cuda.Event()
            event.record(stream)
        queue.append((dev, event))
        if len(queue) > depth:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())


def _accumulate(acc: dict, aux: dict) -> None:
    # Keep device tensors; the host pull happens once per flush window.
    acc.setdefault("preds", []).append(aux["preds"])
    acc.setdefault("labels", []).append(aux["labels"])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flush_metrics(acc: dict, num_classes: int, prefix: str) -> dict:
    if not acc.get("preds"):
        return {}
    preds = np.concatenate([_host(p) for p in acc["preds"]])   # (N, P)
    labels = np.concatenate([_host(l) for l in acc["labels"]])
    out = {}
    npaths = preds.shape[1]
    names = PATHS if npaths == 4 else ("unified",)
    f1s, accs = [], []
    for p, name in enumerate(names):
        yp, yt = preds[:, p], labels[:, p]
        a = M.accuracy(yt, yp)
        f1 = M.f1_score(yt, yp, num_classes, "weighted")
        out[f"{prefix}/{name}_accuracy"] = a
        out[f"{prefix}/{name}_f1"] = f1
        accs.append(a)
        f1s.append(f1)
        for c, cf1 in enumerate(M.f1_score(yt, yp, num_classes, None)):
            out[f"{prefix}/{name}_class{c}_f1"] = float(cf1)
    out[f"{prefix}/avg_accuracy"] = float(np.mean(accs))
    out[f"{prefix}/avg_f1"] = float(np.mean(f1s))
    acc.clear()
    return out


def _checkpoint(state: TrainState) -> dict:
    return {"step": state.step, "params": state.params.state_dict(),
            "optimizer": state.optimizer.state_dict(), "seed": state.seed}


def restore_state(state: TrainState, directory: str) -> TrainState:
    """Load the latest checkpoint of `directory` into `state` (same config)."""
    ckpt = CheckpointManager(directory).restore(map_location="cpu")
    state.params.load_state_dict(ckpt["params"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step, state.seed = int(ckpt["step"]), int(ckpt["seed"])
    return state


def run_training(
    trainer: Trainer,
    train_batches: Callable[[int], Iterable[dict]],
    val_batches: Optional[Callable[[], Iterable[dict]]] = None,
    state: Optional[TrainState] = None,
    logger: Optional[MetricsLogger] = None,
    use_wandb: bool = False,
) -> TrainState:
    """train_batches(epoch) -> iterable of host batches (numpy dicts).

    Returns the final state. Checkpoints to cfg.output_dir/checkpoints;
    real resume via cfg.resume_from (a checkpoints directory).
    """
    cfg = trainer.cfg
    num_classes = cfg.model.num_classes
    own_logger = logger is None
    logger = logger or MetricsLogger(
        cfg.output_dir, use_wandb=use_wandb,
        wandb_project=cfg.wandb_project, wandb_entity=cfg.wandb_entity,
    )
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "checkpoints"))

    if state is None:
        state = trainer.init()
        if cfg.resume_from:
            state = restore_state(state, cfg.resume_from)
            print(f"[train] resumed from {cfg.resume_from} @ step "
                  f"{state.step}")

    best_metric = float("-inf")
    acc: dict = {}
    global_step = state.step
    samples = 0
    t_window = time.time()

    for epoch in range(cfg.epochs):
        stream = prefetch_to_device(
            ({k: v for k, v in b.items() if not k.startswith("_")}
             for b in train_batches(epoch)),
            trainer.device, cfg.prefetch_depth)
        for batch in stream:
            state, aux = trainer.train_step(state, batch)
            global_step += 1
            samples += aux["labels"].shape[0]
            _accumulate(acc, aux)

            if global_step % cfg.log_every == 0:
                dt = time.time() - t_window
                logs = _flush_metrics(acc, num_classes, "train")
                logs["train/total_loss"] = float(aux["loss"])
                logs["train/samples_per_sec"] = samples / max(dt, 1e-9)
                logs["train/learning_rate"] = cfg.lr
                logger.log(logs, step=global_step)
                samples, t_window = 0, time.time()

            if cfg.save_every and global_step % cfg.save_every == 0:
                ckpt.save(global_step, _checkpoint(state))

        if cfg.validate_every_epoch and val_batches is not None:
            val_logs = evaluate(trainer, state, val_batches(), num_classes)
            val_logs["epoch"] = epoch
            logger.log(val_logs, step=global_step)
            if cfg.save_best:
                key = f"val/{cfg.best_metric}"
                cur = val_logs.get(key)
                if cur is not None and cur > best_metric:
                    best_metric = cur
                    save_params(os.path.join(cfg.output_dir,
                                             "best_model.pt"), state.params)
                    logger.log({"val/best_metric": best_metric},
                               step=global_step)

    ckpt.save(global_step, _checkpoint(state))
    if own_logger:
        logger.close()
    return state


def evaluate(trainer: Trainer, state: TrainState,
             batches: Iterable[dict], num_classes: int) -> dict:
    acc: dict = {}
    nll_sum = 0.0
    nll_count = 0
    for batch in batches:
        mask = batch.pop("_pad_mask", None)
        batch = {k: v for k, v in batch.items() if not k.startswith("_")}
        aux = trainer.eval_step(state.params, trainer.shard_batch(batch))
        aux = {k: _host(v) for k, v in aux.items()}
        # val/loss from per-sample nll so the ragged tail's padded duplicate
        # rows don't count and every VALID sample is weighted equally
        nll = aux.pop("nll")
        if mask is not None:
            aux["preds"] = aux["preds"][mask]
            aux["labels"] = aux["labels"][mask]
            nll = nll[mask]
        nll_sum += float(nll.sum())
        nll_count += int(nll.shape[0])
        _accumulate(acc, aux)
    logs = _flush_metrics(acc, num_classes, "val")
    logs["val/loss"] = nll_sum / nll_count if nll_count else 0.0
    return logs
