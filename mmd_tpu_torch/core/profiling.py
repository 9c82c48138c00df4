"""Tracing and per-stage timing for the pipelines (counterpart of
mmd_tpu/core/profiling.py).

  * `stage(name)` / `Stages`: wall-clock per-stage timers that nest, log to
    stdout and accumulate a summary (every pipeline wraps its phases);
  * `trace(log_dir)`: a torch.profiler window over the CPU and, where there
    is one, the card, written as a Chrome trace (`trace.json`);
  * `annotate(name)`: a torch.profiler.record_function range, so a span of
    host code is named inside a trace.

The profilers' shared helpers (the card's name, device time by kernel) are
in mmd_tpu_torch/profiling.py; this module is what the pipelines time
themselves with.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Iterator


class Stages:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self, logger=None):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._logger = logger

    @contextlib.contextmanager
    def stage(self, name: str, log: bool = True) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            if log:
                if self._logger is not None:
                    self._logger.log({f"stage/{name}_sec": dt})
                else:
                    print(f"[stage] {name}: {dt:.3f}s")

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, total in sorted(self.totals.items(), key=lambda x: -x[1]):
            n = self.counts[name]
            lines.append(f"  {name:30s} {total:8.3f}s  ({n}x, "
                         f"{total / n:.3f}s avg)")
        return "\n".join(lines)


_GLOBAL = Stages()


def stage(name: str, log: bool = True):
    """Module-level convenience: `with profiling.stage("embed"): ...`"""
    return _GLOBAL.stage(name, log)


def global_report() -> str:
    return _GLOBAL.report()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A torch.profiler window over the block, written to
    <log_dir>/trace.json (chrome://tracing, Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def annotate(name: str):
    """A named range inside a trace (torch.profiler.record_function)."""
    import torch
    return torch.profiler.record_function(name)
