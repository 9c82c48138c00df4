"""Starting a world of ranks.

`init_from_env` serves a `python -m torch.distributed.run` launch (RANK,
WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE and the rendezvous address in the
environment): rank r takes cuda:{LOCAL_RANK % device_count}, unless the
caller asks for the CPU. `spawn` starts a world of its own in this
process's children, each with its process group on a file store, and
returns what each rank's function returned. `launch_mesh` gives an entry
point the (data, model) mesh of its launch, or None outside one;
`on_rank0` runs a stage that writes files on rank 0 alone, and
`first_on_rank0` a call that writes only at first use on rank 0 first.

The backend is the caller's choice. NCCL runs one rank a card: asked to
put two ranks on one card it raises, and never goes over to gloo. gloo
runs any number of ranks on one card (its collectives stage CUDA tensors
through host memory, parallel/collectives.py) or on the CPU. Both set a
timeout on the process group, and `spawn` on the join, so a rank that
raises or hangs fails the run within a bounded time.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600.0


def _device_for(local_rank: int, device) -> torch.device:
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a rank on cuda was requested but torch sees no "
                           "CUDA device")
    return torch.device("cuda", local_rank % n)


def _check_backend(backend: str, dev: torch.device, ranks_here: int) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend runs on CUDA devices; pass "
                             "gloo for ranks on the CPU")
        cards = torch.cuda.device_count()
        if ranks_here > cards:
            raise RuntimeError(
                f"nccl runs one rank a card: {ranks_here} ranks on this "
                f"host, {cards} CUDA device(s); pass the gloo backend to "
                f"share a card")


def init_from_env(backend: str | None = None, device="cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S
                  ) -> tuple[int, int, torch.device]:
    """Join the world of a torch.distributed.run launch -> (rank, world
    size, this rank's device). A process group already made (a test's
    spawned world) is joined as it is."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        return rank, world, _device_for(local_rank, device)
    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise ValueError(
            f"no torch.distributed.run environment ({', '.join(missing)} "
            f"unset): launch with python -m torch.distributed.run "
            f"--nproc_per_node N -m ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = _device_for(local_rank, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _check_backend(backend, dev,
                   int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, dev


def launch_mesh(backend: str | None = None, device="cuda",
                model_parallel: int = 1,
                timeout_s: float = DEFAULT_TIMEOUT_S):
    """The (data, model) mesh of a torch.distributed.run launch (or of a
    process group already made), else None; outside a launch a
    model_parallel above 1 asks for a mesh of this one process, which
    raises the JAX package's ValueError."""
    from mmd_tpu_torch.core.mesh import make_mesh
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        _, _, dev = init_from_env(backend, device, timeout_s)
        return make_mesh(model_parallel, device=dev)
    if model_parallel > 1:
        return make_mesh(model_parallel, device=device)
    return None


def on_rank0(fn):
    """fn() on rank 0 alone -> its result there, None on the other ranks,
    which run nothing and wait for rank 0 to finish: for a stage that
    writes files every rank then reads. Every rank must call it. A raise
    on rank 0 is raised on every rank (as a RuntimeError on the others).
    Without a process group, fn()."""
    if not dist.is_initialized():
        return fn()
    status, out = [None], None
    if dist.get_rank() == 0:
        try:
            out = fn()
        except BaseException as e:
            status[0] = f"{type(e).__name__}: {e}"
            dist.broadcast_object_list(status, src=0)
            raise
    dist.broadcast_object_list(status, src=0)       # the ranks meet here
    if status[0] is not None:
        raise RuntimeError(f"rank 0 failed: {status[0]}")
    return out


def first_on_rank0(fn):
    """fn() on rank 0, then on the other ranks, which find what rank 0
    wrote: for a call that writes only at first use and only reads after
    (the tokenizer of models/frozen.load_or_init_frozen). A call that
    would write again is on_rank0's."""
    out = on_rank0(fn)
    if dist.is_initialized() and dist.get_rank() != 0:
        return fn()
    return out


def _rank_main(rank: int, fn, world: int, backend: str, device, store: str,
               out_dir: str, timeout_s: float, args: tuple) -> None:
    dev = _device_for(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, dev, *args)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str = "gloo", device="cuda",
          args: tuple = (), timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run fn(rank, world, device, *args) in `world` spawned processes,
    each in a process group of `backend` -> each rank's return value (saved
    with torch.save; keep it to CPU tensors and plain data). fn must be a
    module-level function: the children import it. Rank r takes cuda:{r %
    device_count} unless `device` is the CPU. A rank that raises ends the
    run with its error; a run past `timeout_s` is killed and raises
    TimeoutError."""
    _check_backend(backend, _device_for(0, device), world)
    with tempfile.TemporaryDirectory(prefix="mmd_spawn_") as tmp:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, device,
                              str(Path(tmp) / "store"), tmp, timeout_s,
                              tuple(args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"a world of {world} ranks ran past "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
