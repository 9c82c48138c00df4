"""Checkpointing with real resume (counterpart of mmd_tpu/core/checkpoint.py).

The JAX package saves its TrainState with orbax; the port saves its own
with torch.save: the step, the fusion params (state_dict), the AdamW state
(optimizer.state_dict()) and the seed from which every step's dropout
generator is derived (training/trainer.py::step_generator), so a resumed
run draws the same masks as an uninterrupted one. Files are
<directory>/step_<N>.pt, written atomically; the oldest beyond
`max_to_keep` are deleted. Params alone (best_model.pt, the encoder
assets) are save_params files: a module's state dict.

The JAX package's orbax directories (best_model, <name>.ckpt) need JAX to
read; tools/orbax_to_torch.py turns them into save_params files beside
them. `read_params` refuses an orbax directory and names that script.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _save(obj: Any, path: Path) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> None:
        """state: a dict of tensors, state_dicts and Python scalars."""
        _save(state, self.directory / f"step_{int(step)}.pt")
        for old in self.all_steps()[:-self.max_to_keep]:
            (self.directory / f"step_{old}.pt").unlink(missing_ok=True)

    def restore(self, step: Optional[int] = None,
                map_location: Any = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.directory / f"step_{int(step)}.pt",
                          map_location=map_location, weights_only=True)


def save_params(path: str, params: torch.nn.Module) -> None:
    """One-shot param save (best_model.pt equivalent, train.py:419-428)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    _save(params.state_dict(), Path(path))


def orbax_error(path: str | os.PathLike, want: str | os.PathLike
                ) -> FileNotFoundError:
    return FileNotFoundError(
        f"{path} is an orbax checkpoint of the JAX package, which the port "
        f"does not read, and {want} is missing: convert it with "
        f"`python tools/orbax_to_torch.py` where JAX is installed")


def read_params(path: str | os.PathLike) -> dict:
    """The state dict of a save_params file, on the CPU. An orbax
    directory raises."""
    if Path(path).is_dir():
        raise orbax_error(path, Path(path).with_suffix(".pt"))
    return torch.load(path, map_location="cpu", weights_only=True)


def load_params(path: str, params: torch.nn.Module) -> torch.nn.Module:
    """Load a save_params file into a module of the same structure."""
    params.load_state_dict(read_params(path))
    return params
