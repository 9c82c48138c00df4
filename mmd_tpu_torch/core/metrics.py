"""Structured metrics logging: JSONL writer + optional wandb adapter (the
port's copy of mmd_tpu/core/metrics.py).

The reference logs every step straight to wandb (reference
train.py:177-182), making runs network-dependent. Here the primary sink is
an append-only JSONL file (always works, diffable, parseable by bench
tooling); wandb attaches on top when importable and enabled.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, output_dir: str, use_wandb: bool = False,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None,
                 config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                kwargs = {"project": wandb_project, "config": config or {}}
                if wandb_entity:
                    kwargs["entity"] = wandb_entity
                self._wandb = wandb.init(**kwargs)
            except Exception as e:  # offline / unavailable: JSONL still works
                print(f"[metrics] wandb unavailable ({e}); JSONL only")

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        rec = {"t": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
