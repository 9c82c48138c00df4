"""Collectives over one axis of a mesh: the port's counterparts of
`lax.all_gather(tiled=True)`, `lax.ppermute` and `lax.psum` inside the
JAX package's shard_map bodies (`lax.axis_index` is `Mesh.axis_index`),
plus the point-to-point hops and the broadcast of the pipeline schedule.

Each runs on the process group of this rank's line along the axis
(core/mesh.py); an axis of size 1 returns its input. The backend is the
caller's, chosen when the process group was made, and nothing here
switches it: an NCCL group passes CUDA tensors directly, and a gloo group,
which carries host tensors only, receives a CUDA tensor staged through a
pinned host buffer and hands the result back on the tensor's device.
`staged_bytes` counts the bytes so staged in this process, both ways; a
run resets it to 0 and reads it back.
"""

from __future__ import annotations

import threading

import torch
import torch.distributed as dist

# bytes copied between a CUDA tensor and a pinned host buffer for a gloo
# collective in this process (device to host plus host to device)
staged_bytes = 0
_lock = threading.Lock()


def _count(nbytes: int) -> None:
    global staged_bytes
    with _lock:
        staged_bytes += nbytes


def _staged(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_wire(x: torch.Tensor, stage: bool) -> torch.Tensor:
    """x as the collective carries it: contiguous, and in a pinned host
    buffer when staged."""
    x = x.contiguous()
    if stage and x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        _count(x.numel() * x.element_size())
        x = buf
    return x


def _wire_buffer(like: torch.Tensor, stage: bool) -> torch.Tensor:
    """An empty wire tensor for `like` (pinned on the host when staged)."""
    host = stage and like.is_cuda
    return torch.empty(like.shape, dtype=like.dtype,
                       device="cpu" if host else like.device,
                       pin_memory=host)


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received or reduced wire tensor back on `like`'s device."""
    if w.device != like.device:
        w = w.to(like.device)
        _count(w.numel() * w.element_size())
    return w


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0
               ) -> torch.Tensor:
    """lax.all_gather(x, axis, axis=dim, tiled=True): every rank's x along
    `axis`, concatenated on `dim` in axis order."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    group = mesh.group(axis)
    w = _to_wire(x, _staged(group))
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return _from_wire(torch.cat(parts, dim), x)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """lax.psum(x, axis): the sum of every rank's x along `axis`."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.group(axis)
    w = _to_wire(x, _staged(group))
    if w is x:                          # reduce into a copy, not into x
        w = x.clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(w, x)


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """lax.ppermute(x, axis, perm): each (src, dst) pair of axis indices
    sends src's x to dst; a rank that receives nothing gets zeros."""
    if mesh.shape[axis] == 1:
        return x if any(s == d == 0 for s, d in perm) else torch.zeros_like(x)
    group = mesh.group(axis)
    stage = _staged(group)
    me, ranks = mesh.axis_index(axis), mesh.axis_ranks(axis)
    w = _to_wire(x, stage)
    got = _wire_buffer(x, stage).zero_()
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, w, ranks[dst], group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, got, ranks[src], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(got, x)


def send(x: torch.Tensor, mesh, axis: str, dst: int) -> None:
    """Send x to the rank at axis index `dst` (blocking)."""
    group = mesh.group(axis)
    w = _to_wire(x, _staged(group))
    dist.send(w, mesh.axis_ranks(axis)[dst], group=group)


def recv(like: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Receive a tensor of `like`'s shape, dtype and device from the rank
    at axis index `src` (blocking)."""
    group = mesh.group(axis)
    w = _wire_buffer(like, _staged(group))
    dist.recv(w, mesh.axis_ranks(axis)[src], group=group)
    return _from_wire(w, like)


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """The x of the rank at axis index `src`, on every rank along `axis`
    (the other ranks' x gives only the shape, dtype and device)."""
    if mesh.shape[axis] == 1:
        return x
    group = mesh.group(axis)
    stage = _staged(group)
    w = (_to_wire(x, stage) if mesh.axis_index(axis) == src
         else _wire_buffer(x, stage))
    dist.broadcast(w, mesh.axis_ranks(axis)[src], group=group)
    return _from_wire(w, x)
