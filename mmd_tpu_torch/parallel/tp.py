"""Tensor parallelism over the mesh's "model" axis, and the spec rules of
the fusion model's training state (counterpart of
mmd_tpu/parallel/tp.py).

The Megatron split. For the fusion model (`state_specs`): the Q/K/V and
evidence key/value projections, the MLPs' fc1 and the classifier heads'
fc0 by column (each rank owns num_heads/tp heads end to end, 1/tp of the
MLP's hidden units and of a head's first layer); every *_out projection,
the MLPs' fc2 and the heads' fc1 by row (the partial products are summed
over the axis, and the bias, kept whole, is added after the sum); input
projections, LayerNorms and deeper head layers replicated. For the
encoders (`encoder_specs`, serving): q, k, v and ffn_in by column,
attn_out and ffn_out by row; embeddings, LayerNorms, the relative position
tables and the pooler replicated.

Specs are given as the JAX package gives them: per leaf (a state-dict name
of the port's tree), a tuple of axis names or None, one entry a dim, in
the JAX layout. A JAX weight is (in, out) and the port's nn.Linear weight
(out, in), so a JAX dim j of a Linear weight is the port's dim 1 - j: a
column split is the port's dim 0, a row split its dim 1, and ZeRO's
"leading dim" (`zero1_specs`, `zero3_specs`) is the port's dim 1 of a
weight, so that the same leaves are split as in the JAX package and every
rank holds the same shard shapes. `shard_tree` / `gather_tree` move a tree
between the whole and a rank's blocks under such specs.

The JAX package leaves the partitioning to GSPMD; here the rank's heads
run the kernels on its device (#1, and #10 at h/tp heads of the same head
dim), as a shard_map would, and the forward (models/fusion.py,
models/layers.py, models/transformer.py, models/deberta.py) takes a
`TensorParallel` axis: `copy` where a replicated activation enters a
column-split layer and `reduce` after a row-split one, both seen by
autograd (parallel/collectives.py). `FusionParallel` holds the rule by
which the training dropout seeds of a mesh are folded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mmd_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops.attention import fold_seed
from mmd_tpu_torch.parallel import collectives as C

_COL = "col"    # weight (out, in) split along out (dim 0), bias along dim 0
_ROW = "row"    # weight (out, in) split along in (dim 1), bias replicated

# the fusion model's column-split projections (mmd_tpu/parallel/tp.py:38-70)
_COL_NAMES = frozenset({
    "text_WQ", "text_WK", "text_WV", "image_WQ", "image_WK", "image_WV",
    "text_evidence_key", "text_evidence_value",
    "image_evidence_key", "image_evidence_value",
})


def _split_kind(path) -> Optional[str]:
    """Classify a fusion leaf by the module names along its path."""
    path = list(path)
    in_mlp = any(n in ("text_mlp", "image_mlp") for n in path)
    in_classifier = "classifier" in path
    for n in reversed(path):
        if n in _COL_NAMES:
            return _COL
        if n.endswith("_out"):
            return _ROW
        if in_mlp and n == "fc1":
            return _COL
        if in_mlp and n == "fc2":
            return _ROW
        if in_classifier and n == "fc0":
            return _COL
        if in_classifier and n == "fc1":
            return _ROW
    return None

# models/transformer.py::init_layer's names (the BERT/MPNet/ViT/captioner
# stacks) and models/deberta.py::init_deberta's: q/k/v and ffn_in by column
# (heads / hidden), every *_out projection (attn_out, xattn_out, ffn_out)
# by row
_ENC_COL = frozenset({"q", "k", "v", "xq", "xk", "xv", "ffn_in"})


def _enc_split_kind(path) -> Optional[str]:
    """Classify a leaf by the module names along its path."""
    for n in reversed(list(path)):
        if n in _ENC_COL:
            return _COL
        if n.endswith("_out"):
            return _ROW
    return None


def _split_dim(kind: Optional[str], leaf: str, ndim: int) -> Optional[int]:
    if kind == _COL:
        return 0
    if kind == _ROW and leaf == "weight" and ndim == 2:
        return 1
    return None      # replicated; a row-split bias is added after the sum


def encoder_specs(params: nn.Module) -> dict:
    """{state-dict key: the dim of the tensor split over the model axis,
    or None for replicated} for an encoder param tree (DeBERTa,
    BERT/MPNet, ViT, captioner: anything built on transformer.py's layer
    names)."""
    out = {}
    for name, t in params.state_dict().items():
        *path, leaf = name.split(".")
        out[name] = _split_dim(_enc_split_kind(path), leaf, t.dim())
    return out


def shard_encoder(params: nn.Module, mesh, axis: str = MODEL_AXIS
                  ) -> nn.Module:
    """A copy of params holding this rank's slice of every split tensor,
    and the replicated tensors whole, on the mesh's device; params stay as
    they were. The split widths must divide by the axis."""
    tp, i = mesh.shape[axis], mesh.axis_index(axis)
    specs = encoder_specs(params)
    params = L.shared_copy(params)
    for name, prm in list(params.named_parameters()):
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = params.get_submodule(owner)
        data, dim = prm.detach(), specs[name]
        if dim is not None:
            n = data.shape[dim]
            if n % tp:
                raise ValueError(f"{name} has {n} along the split dim, not "
                                 f"divisible by model axis {tp}")
            data = data.narrow(dim, i * (n // tp), n // tp)
        setattr(mod, leaf, nn.Parameter(
            data.contiguous().to(mesh.device, copy=True),
            requires_grad=False))
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    return params


# -- the training state's specs, in the JAX layout ------------------------------

def _linear_weights(params: nn.Module) -> set:
    return {f"{m}.weight" if m else "weight"
            for m, mod in params.named_modules()
            if isinstance(mod, nn.Linear)}


def jax_shapes(params: nn.Module) -> dict:
    """{name: the leaf's shape in the JAX layout} of every parameter, in
    the order of params.parameters() (the optimizer's)."""
    lin = _linear_weights(params)
    return {n: tuple(reversed(p.shape)) if n in lin else tuple(p.shape)
            for n, p in params.named_parameters()}


def _tp_spec(name: str, ndim: int) -> tuple:
    *path, _ = name.split(".")
    kind = _split_kind(path)
    if kind == _COL and ndim in (1, 2):
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if kind == _ROW and ndim == 2:
        return (MODEL_AXIS, None)
    return (None,) * ndim        # a row-split bias is added after the sum


def _leading(shape: tuple, data_size: int) -> tuple:
    if shape and shape[0] > 0 and shape[0] % data_size == 0:
        return (DATA_AXIS,) + (None,) * (len(shape) - 1)
    return (None,) * len(shape)


def state_specs(params: nn.Module) -> dict:
    """The Megatron specs of a fusion tree: {name: spec} (JAX layout). The
    AdamW moments mirror the params and take the same specs."""
    return {n: _tp_spec(n, len(s)) for n, s in jax_shapes(params).items()}


def zero1_specs(params: nn.Module, data_size: int) -> dict:
    """ZeRO-1: the params replicated, each moment sharded over "data" along
    its leading dim where that divides (Adam's count stays replicated)."""
    shapes = jax_shapes(params)
    return {"params": {n: (None,) * len(s) for n, s in shapes.items()},
            "moments": {n: _leading(s, data_size)
                        for n, s in shapes.items()}}


def tp_zero1_specs(params: nn.Module, data_size: int) -> dict:
    """TP + ZeRO-1: the params take the Megatron specs; each moment keeps
    its TP split and shards its first TP-free dim over "data" where that
    divides."""
    tp = state_specs(params)
    moments = {}
    for n, shape in jax_shapes(params).items():
        dims = list(tp[n])
        for i, d in enumerate(dims):
            if d is None and shape[i] > 0 and shape[i] % data_size == 0:
                dims[i] = DATA_AXIS
                break
        moments[n] = tuple(dims)
    return {"params": tp, "moments": moments}


def zero3_specs(params: nn.Module, data_size: int) -> dict:
    """ZeRO-3: the params and the moments sharded over "data" along their
    leading dim where that divides."""
    z = {n: _leading(s, data_size) for n, s in jax_shapes(params).items()}
    return {"params": z, "moments": dict(z)}


def validate_tp_config(mcfg, mesh) -> None:
    tp = mesh.shape[MODEL_AXIS]
    if mcfg.num_heads % tp != 0:
        raise ValueError(
            f"num_heads={mcfg.num_heads} must divide by model axis {tp}")
    hidden = int(mcfg.embed_dim * mcfg.mlp_ratio)
    if (mcfg.embed_dim % tp != 0 or hidden % tp != 0
            or mcfg.hidden_dim % tp != 0):
        raise ValueError(
            f"embed_dim={mcfg.embed_dim}/hidden={hidden}/"
            f"head hidden={mcfg.hidden_dim} not divisible by model axis {tp}")


def port_dims(params: nn.Module, specs: dict) -> dict:
    """{name: {axis: the port dim split over it}} of JAX-layout specs."""
    lin = _linear_weights(params)
    out = {}
    for name, spec in specs.items():
        n = len(spec)
        out[name] = {a: (n - 1 - j if name in lin else j)
                     for j, a in enumerate(spec) if a is not None}
    return out


def local_block(t: torch.Tensor, dims: dict, mesh) -> torch.Tensor:
    """This rank's block of a whole tensor split over {axis: dim}."""
    for axis, dim in dims.items():
        parts, n = mesh.shape[axis], t.shape[dim]
        if n % parts:
            raise ValueError(f"{n} along dim {dim} does not divide over the "
                             f"{parts} ranks of axis {axis!r}")
        t = t.narrow(dim, mesh.axis_index(axis) * (n // parts), n // parts)
    return t


def gather_blocks(blocks: list, dims: list, mesh) -> list:
    """The whole tensors from every rank's blocks, each split over its
    {axis: dim} of `dims`: one all-gather an axis (a collective: every
    rank calls it with blocks of the same names)."""
    out = list(blocks)
    for axis in (MODEL_AXIS, DATA_AXIS):
        idx = [i for i, d in enumerate(dims) if axis in d]
        whole = C.all_gather_many([out[i] for i in idx],
                                  [dims[i][axis] for i in idx], mesh, axis)
        for i, t in zip(idx, whole):
            out[i] = t
    return out


def _replace_leaves(params: nn.Module, tensors: dict) -> nn.Module:
    """A shared_copy of params with each parameter replaced by the tensor
    of its name, the Linear modules' features set to the shapes."""
    params = L.shared_copy(params)
    for name, prm in list(params.named_parameters()):
        owner, leaf = name.rsplit(".", 1) if "." in name else ("", name)
        mod = params.get_submodule(owner)
        setattr(mod, leaf, nn.Parameter(tensors[name],
                                        requires_grad=prm.requires_grad))
        if isinstance(mod, nn.Linear):
            mod.out_features, mod.in_features = mod.weight.shape
    return params


def shard_tree(params: nn.Module, specs: dict, mesh) -> nn.Module:
    """A copy of a whole tree holding this rank's block of every leaf
    under `specs` (JAX layout), on the mesh's device."""
    dims = port_dims(params, specs)
    return _replace_leaves(params, {
        n: local_block(p.detach(), dims[n], mesh).contiguous().to(
            mesh.device, copy=True) for n, p in params.named_parameters()})


def gather_tree(params: nn.Module, specs: dict, mesh) -> nn.Module:
    """The whole tree from every rank's blocks under `specs` (a
    collective); leaves kept whole are shared, not copied."""
    dims = port_dims(params, specs)
    names = list(dims)
    got = dict(zip(names, gather_blocks(
        [p.detach() for p in params.parameters()], [dims[n] for n in names],
        mesh)))
    return _replace_leaves(params, got)


class TensorParallel:
    """The model axis of a mesh as a Megatron-split encoder sees it: its
    size, this rank's heads, the local geometry, and the sum of partial
    products over the axis."""

    def __init__(self, mesh, axis: str = MODEL_AXIS):
        self.mesh, self.axis = mesh, axis
        self.size = mesh.shape[axis]
        self.index = mesh.axis_index(axis)

    def heads(self, num_heads: int) -> slice:
        n = num_heads // self.size
        return slice(self.index * n, (self.index + 1) * n)

    def local_config(self, cfg):
        """cfg at this rank's width: num_heads/tp heads of the same dim."""
        return dataclasses.replace(cfg, num_heads=cfg.num_heads // self.size,
                                   hidden_size=cfg.hidden_size // self.size)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial products (autograd: identity)."""
        return C.reduce_from_axis(y, self.mesh, self.axis)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x where column-split layers read it (autograd: psum)."""
        return C.copy_to_axis(x, self.mesh, self.axis)

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim of a replicated x (its heads'
        columns), through `copy`; contiguous, as the kernels take it."""
        n = x.shape[-1] // self.size
        return self.copy(x)[..., self.index * n:(self.index + 1) * n
                            ].contiguous()


class FusionParallel:
    """The mesh as the fusion model's training forward sees it: the data
    index every dropout seed folds in, and, when the params are the
    Megatron split, the model axis (`tp`).

    The one rule for the dropout seeds of a mesh. A site's seed is drawn
    as on one device and split as on one device (`split`); each seed is
    then folded by the rank's data index, so ranks of another data index
    draw their own masks, and, when under TP it drops a slice that is the
    rank's own (the attention probabilities of its heads, the hidden units
    of its MLP or head slice), by its model index too. A seed of a
    dropout on replicated columns (an MLP's or a head's output) is folded
    by data alone, so every model rank draws the same mask there. Index
    (0, 0) leaves every seed unchanged: a world of one draws the
    single-device masks."""

    def __init__(self, mesh, tensor_parallel: bool = False):
        self.mesh = mesh
        self.data_index = mesh.axis_index(DATA_AXIS)
        self.tp = TensorParallel(mesh) if tensor_parallel else None

    def seed(self, seed: Optional[int], local: bool = False
             ) -> Optional[int]:
        """`seed` folded by the data index, and by the model index for a
        site that drops a rank-local slice (local=True under TP)."""
        if seed is None:
            return None
        if local and self.tp is not None:
            return fold_seed(seed, self.data_index, self.tp.index)
        return fold_seed(seed, self.data_index)

    def split(self, seed: Optional[int], n: int) -> list:
        """The n seeds of an MLP or a classifier head split from its layer
        seed (dropout.split_seed), each folded: the first drops the hidden
        units (the rank's slice under TP), the others replicated
        columns."""
        if seed is None:
            return [None] * n
        return [self.seed(s, local=i == 0)
                for i, s in enumerate(D.split_seed(seed, n))]


def tensor_parallel_encode(params, cfg, input_ids: torch.Tensor,
                           attention_mask: Optional[torch.Tensor] = None, *,
                           mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """last_hidden_state (B, T, D) of the text encoder (BERT-class or
    DeBERTa) whose params shard_encoder split over `axis`, on every
    rank."""
    from mmd_tpu_torch.models.deberta import DebertaConfig, deberta_encode
    from mmd_tpu_torch.models.transformer import transformer_forward

    tp = TensorParallel(mesh, axis)
    if cfg.num_heads % tp.size:
        raise ValueError(f"num_heads={cfg.num_heads} must divide by model "
                         f"axis {tp.size}")
    if isinstance(cfg, DebertaConfig):
        return deberta_encode(params, cfg, input_ids, attention_mask, tp=tp)
    return transformer_forward(params, cfg, input_ids,
                               attention_mask=attention_mask, tp=tp)
