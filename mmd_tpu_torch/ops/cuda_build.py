"""Build the package's CUDA sources with nvcc at first use and load them.

Each library is compiled from the sources under `ops/csrc/` into a shared
object with a plain C interface, then loaded with ctypes. The build lands
in `build/mmd_tpu_torch/` at the root of the checkout, keyed by a hash of
the sources and the flags, so an edited source never loads a stale build.
A missing nvcc or a failed compile raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mmd_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
# one lock per library, so that builds of different libraries overlap
_lib_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# seconds each library took to compile in this process (absent: it was
# already built on disk)
build_seconds: dict[str, float] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return nvcc


def load_library(name: str, sources: Sequence[str],
                 headers: Sequence[str] = (),
                 defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile `sources` (names under csrc/) into lib<name>-<hash>.so if that
    build does not exist yet, and load it once per process. `headers` (names
    under csrc/ that the sources include) are part of the hash only;
    `defines` ("NAME=VALUE") go to nvcc as -D flags and into the hash."""
    with _lock:
        lib_lock = _lib_locks.setdefault(name, threading.Lock())
    with lib_lock:
        if name in _loaded:
            return _loaded[name]
        paths = [CSRC / s for s in sources]
        flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        digest = hashlib.sha256(" ".join(flags).encode())
        for p in [*paths, *(CSRC / h for h in headers)]:
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [find_nvcc(), *flags, "-o", str(tmp), *map(str, paths)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {res.returncode}: "
                    f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)        # atomic: a concurrent loader sees
            build_seconds[name] = time.perf_counter() - t0  # all or nothing
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def device_index(t) -> int:
    """The CUDA ordinal of tensor `t`'s device."""
    import torch
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def on_cuda(x, what: str) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device.type}")
    return True


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def check_aligned(*tensors) -> None:
    """The kernels load 16 bytes at a time."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the kernel takes 16-byte aligned tensors")
