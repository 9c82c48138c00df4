"""Collectives over one axis of a mesh: the port's counterparts of
`lax.all_gather(tiled=True)`, `lax.ppermute`, `lax.psum` and
`lax.psum_scatter(tiled=True)` inside the JAX package's shard_map bodies
(`lax.axis_index` is `Mesh.axis_index`), plus the point-to-point hops and
the broadcast of the pipeline schedule and the in-place sum and mean of a
list of gradients.

These return fresh tensors that autograd cannot see through. The
operators that it can see through each carry their JAX transpose:
  * `copy_to_axis` (identity forward, psum of the gradient backward) and
    `reduce_from_axis` (psum forward, identity backward), the two
    Megatron operators;
  * `all_gather_grad` (a reduce-scatter of the gradient backward), for a
    gathered block every rank reads, as the K/V blocks of sequence
    parallelism;
  * `gather_replicated` (this rank's tile of the gradient backward), for
    a result that work repeated along the axis reads, as the encoder
    output that every model rank's fusion model reads: each rank then
    holds the whole gradient, and a reduce-scatter would count it once a
    rank;
  * `ppermute_grad` (the ppermute of the gradient along the inverted
    pairs backward), for ring attention.
The pipeline's hops go back one stage in its own backward schedule
(parallel/pp.py).

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


def reduce_scatter(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """lax.psum_scatter(x, axis, tiled=True): the sum of every rank's x
    along `axis`, of which this rank keeps its tile of dim 0 (tile i for
    axis index i)."""
    n = mesh.shape[axis]
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not divide over "
                         f"the {n} ranks of axis {axis!r}")
    group = mesh.group(axis)
    stage = _staged(group)
    parts = [_to_wire(p, stage) for p in x.chunk(n)]
    out = _wire_buffer(parts[0], stage)
    dist.reduce_scatter(out, parts, op=dist.ReduceOp.SUM, group=group)
    return _from_wire(out, x)


def psum_(tensors: list, mesh, axis: str, mean: bool = False) -> None:
    """Replace each tensor of the list (one dtype and device) by its sum
    over `axis` (its mean with `mean`), in place, through one all-reduce of
    their concatenation."""
    n = mesh.shape[axis]
    if n == 1 or not tensors:
        return
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), mesh, axis)
    if mean:
        flat.div_(n)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def pmean_(tensors: list, mesh, axis: str) -> None:
    """psum_ with the mean."""
    psum_(tensors, mesh, axis, mean=True)


def _tiles(x: torch.Tensor, dim: int, n: int) -> list:
    """x's n tiles along dim, each flattened with dim first."""
    return [t.movedim(dim, 0).reshape(-1) for t in x.chunk(n, dim)]


def _untile(flat: torch.Tensor, shape, dim: int) -> torch.Tensor:
    """A flat tile back to `shape` (dim first when flattened)."""
    moved = [shape[dim]] + [s for i, s in enumerate(shape) if i != dim]
    return flat.view(moved).movedim(0, dim)


def all_gather_many(tensors: list, dims: list, mesh, axis: str) -> list:
    """[all_gather(x, mesh, axis, dim) for each x and dim], through one
    all-gather of their concatenation (one dtype and device)."""
    n = mesh.shape[axis]
    if n == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([x.movedim(d, 0).reshape(-1)
                      for x, d in zip(tensors, dims)])
    parts = all_gather(flat, mesh, axis).view(n, -1)
    out, off = [], 0
    for x, d in zip(tensors, dims):
        k = x.numel()
        out.append(torch.cat([_untile(parts[r, off:off + k], x.shape, d)
                              for r in range(n)], d))
        off += k
    return out


def reduce_scatter_many(tensors: list, dims: list, mesh, axis: str
                        ) -> list:
    """Each x's sum over `axis`, of which this rank keeps its tile along its
    dim (`reduce_scatter` along any dim), through one reduce-scatter of
    their tiles, rank by rank (one dtype and device)."""
    n = mesh.shape[axis]
    if n == 1 or not tensors:
        return list(tensors)
    for x, d in zip(tensors, dims):
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"over the {n} ranks of axis {axis!r}")
    tiles = [_tiles(x, d, n) for x, d in zip(tensors, dims)]
    flat = torch.cat([torch.cat([t[r] for t in tiles]) for r in range(n)])
    mine = reduce_scatter(flat, mesh, axis)
    out, off = [], 0
    for x, d, t in zip(tensors, dims, tiles):
        k = t[0].numel()
        shape = list(x.shape)
        shape[d] //= n
        out.append(_untile(mine[off:off + k], shape, d))
        off += k
    return out


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.float(), ctx.mesh, ctx.axis).to(g.dtype), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """x, unchanged, where a rank's column-split layers read it: the
    backward sums the gradient over `axis` (in fp32), so a replicated
    input collects every rank's part of its gradient."""
    if mesh.shape[axis] == 1:
        return x
    return _CopyToAxis.apply(x, mesh, axis)


def reduce_from_axis(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over `axis` of every rank's x (a row-split layer's partial
    products; pass fp32): the backward hands each rank the gradient as it
    is."""
    if mesh.shape[axis] == 1:
        return x
    return _ReduceFromAxis.apply(x, mesh, axis)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g32 = reduce_scatter_many([g.float()], [ctx.dim], ctx.mesh,
                                  ctx.axis)[0]
        return g32.to(g.dtype), None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.n, ctx.i, ctx.dim = (mesh.shape[axis], mesh.axis_index(axis),
                                 dim)
        return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.i].contiguous(), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return ppermute(g, ctx.mesh, ctx.axis, back), None, None, None


def all_gather_grad(x: torch.Tensor, mesh, axis: str, dim: int = 0
                    ) -> torch.Tensor:
    """all_gather for autograd: every rank reads the gathered whole, so the
    backward sums the ranks' gradients of it and keeps this rank's tile
    (a reduce-scatter along `dim`, in fp32)."""
    if mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def gather_replicated(x: torch.Tensor, mesh, axis: str, dim: int = 0
                      ) -> torch.Tensor:
    """all_gather for autograd where the ranks along `axis` go on with the
    same work on the gathered whole, so each holds its whole gradient:
    the backward keeps this rank's tile of it."""
    if mesh.shape[axis] == 1:
        return x
    return _GatherReplicated.apply(x, mesh, axis, dim)


def ppermute_grad(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """ppermute for autograd: the backward sends the gradient back along
    the inverted pairs."""
    if mesh.shape[axis] == 1:
        return ppermute(x, mesh, axis, perm)
    return _Ppermute.apply(x, mesh, axis, perm)


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
