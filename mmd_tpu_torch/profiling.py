"""What the profilers (profile_serve.py, profile_train.py) share: the card's
name, host-clock timing, and a torch.profiler window reduced to device time
by operation.

Device time is the sum of the kernel and copy events on the card; host-side
operators are left out, since their kernels already carry their device
time. Each event is named by the port's kernel whose symbol it holds, or
else kept under its own name and grouped by the first substring of GROUPS
(or the caller's extra groups) that it contains.
"""

from __future__ import annotations

import subprocess
import time

import torch

# substring of a library kernel's name -> its group
GROUPS = (("Memcpy", "copies"), ("gemm", "matmul"), ("xmma", "matmul"),
          ("cutlass", "matmul"), ("nvjet", "matmul"), ("roll_cuda", "roll"),
          ("copy_kern", "dtype casts"), ("softmax", "softmax"),
          ("layer_norm", "layer_norm"), ("reduce", "reductions"),
          ("elementwise", "elementwise"), ("CatArray", "cat"),
          ("index", "index/gather"), ("gather", "index/gather"))


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def timed(fn, n: int) -> list[float]:
    """Host-clock milliseconds of n calls, each ending in a device sync."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def device_us(evt) -> float:
    """Microseconds of a device-side event (a kernel or a copy); 0 for the
    host-side operators."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_summary(events, window_ms: float, kernels: dict[str, str],
                   groups=GROUPS, top: int = 15) -> dict:
    """Reduce `events` (a profiler's key_averages()) over a window of
    `window_ms` on the host clock. `kernels` maps a kernel symbol to the
    port's kernel name."""
    by_name: dict[str, float] = {}
    launches = 0
    for evt in events:
        us = device_us(evt)
        if us <= 0:
            continue
        name = next((v for k, v in kernels.items() if k in evt.key), evt.key)
        by_name[name] = by_name.get(name, 0.0) + us
        launches += evt.count
    busy_ms = sum(by_name.values()) / 1e3
    ours = set(kernels.values())
    by_group: dict[str, float] = {}
    for name, us in by_name.items():
        g = name if name in ours else next(
            (v for k, v in groups if k in name), "other")
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
    longest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_ms": window_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / window_ms if window_ms else None,
        "device_events": launches,
        "device_ms_by_group": dict(sorted(by_group.items(),
                                          key=lambda kv: -kv[1])),
        "device_ms_top": {k[:80]: v / 1e3 for k, v in longest},
        "kernels_ms": {v: by_name.get(v, 0.0) / 1e3
                       for v in dict.fromkeys(kernels.values())},
    }


def profile_window(fn, n: int, kernels: dict[str, str],
                   groups=GROUPS) -> dict:
    """n calls of fn under torch.profiler (CPU and CUDA activities), ended
    by a device sync, reduced by device_summary."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    return device_summary(prof.key_averages(), window_ms, kernels, groups)
