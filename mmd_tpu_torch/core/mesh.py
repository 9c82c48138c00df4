"""The (data, model) mesh of torch.distributed ranks (counterpart of
mmd_tpu/core/mesh.py).

The JAX package lays its devices out as a 2-D ("data", "model") grid: DP
shards the batch over "data", retrieval corpora shard their rows, and the
"model" axis carries the parallel text encoders. Here a device is a rank of
the default process group, and the grid is the JAX package's
`np.asarray(devices).reshape(n // mp, mp)` over ranks 0 .. n-1: rank r sits
at (r // mp, r % mp). A collective over an axis runs on the process group
of this rank's row ("model") or column ("data"); `make_mesh` creates one
group for each row and each column, on every rank and in one fixed order,
as torch.distributed requires. An axis of size 1 needs no group.

Each rank holds its own device (`Mesh.device`, given by the caller: a
torch.distributed.run launch takes cuda:{LOCAL_RANK}, see
parallel/launch.py). The JAX batch and corpus shardings become the rows a
rank holds. `require_tpu` is not ported (ROADMAP A15).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A (data, model) grid of ranks seen from one rank: `shape` (a dict,
    as JAX's), `size`, `devices` (the grid of ranks), `axis_index(axis)`,
    `axis_ranks(axis)`, `group(axis)` and `device`."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray, rank: int,
                 device: torch.device, groups: dict):
        self.devices = devices
        self.rank = rank
        self.device = device
        self._groups = groups
        self._coords = tuple(int(c) for c in
                             np.argwhere(devices == rank)[0])

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _dim(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in mesh {self.axis_names}")
        return self.axis_names.index(axis)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (lax.axis_index)."""
        return self._coords[self._dim(axis)]

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks along `axis` through this rank, in axis order."""
        if self._dim(axis) == 0:
            return self.devices[:, self._coords[1]].tolist()
        return self.devices[self._coords[0], :].tolist()

    def group(self, axis: str):
        """The process group of this rank's line along `axis`; None for an
        axis of size 1."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at "
                f"{dict(zip(self.axis_names, self._coords))}, "
                f"{self.device})")


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but torch sees no "
                               f"CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """Build a (data, model) mesh over the ranks of the default process
    group (a world of one without torch.distributed). Every rank of the
    world must call it, with the same model_parallel."""
    if dist.is_available() and dist.is_initialized():
        n, rank = dist.get_world_size(), dist.get_rank()
    else:
        n, rank = 1, 0
    if model_parallel < 1 or n % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide device count {n}")
    grid = np.arange(n).reshape(n // model_parallel, model_parallel)
    groups = {}
    # every rank creates every group, rows first, then columns
    if grid.shape[1] > 1:
        for row in grid:
            g = dist.new_group(row.tolist())
            if rank in row:
                groups[MODEL_AXIS] = g
    if grid.shape[0] > 1:
        for col in grid.T:
            g = dist.new_group(col.tolist())
            if rank in col:
                groups[DATA_AXIS] = g
    return Mesh(grid, rank, _resolve(device), groups)


def local_mesh(device="cuda") -> Mesh:
    """A mesh over every rank of the world, pure DP."""
    return make_mesh(model_parallel=1, device=device)


def shard_rows(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> slice:
    """The rows of a leading dim of n that this rank holds when the dim is
    sharded over `axis` (PartitionSpec(axis)): n must divide evenly."""
    parts = mesh.shape[axis]
    if n % parts:
        raise ValueError(f"{n} rows do not divide over the {parts} ranks of "
                         f"axis {axis!r}")
    lo = mesh.axis_index(axis) * (n // parts)
    return slice(lo, lo + n // parts)


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """Shard the leading (batch) dim over the data axis: this rank's rows."""
    return shard_rows(mesh, n, DATA_AXIS)


def corpus_sharding(mesh: Mesh, n: int, axis: str = DATA_AXIS) -> slice:
    """Retrieval corpora shard their row dim across the ranks of `axis`, so
    the corpus matmul and top-k run distributed (ops/topk.make_sharded_topk):
    this rank's rows."""
    return shard_rows(mesh, n, axis)


def host_rows(batch, mesh: Mesh) -> dict:
    """This rank's rows of each array of a host batch (a dict of arrays or
    tensors), still on the host."""
    return {k: x[batch_sharding(mesh, len(x))] for k, x in batch.items()}


def shard_batch(batch, mesh: Mesh, device: Optional[torch.device] = None):
    """A host batch (a dict of arrays or tensors) as this rank's rows of
    each, on the mesh's device."""
    dev = device or mesh.device
    # a copy: the rows never alias the caller's host buffers
    return {k: torch.as_tensor(x).to(dev, copy=True)
            for k, x in host_rows(batch, mesh).items()}