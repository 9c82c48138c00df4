"""The fusion model's training state over a (data, model) mesh: where a
rank's blocks lie (`Layout`) and the AdamW that steps them
(`ShardedAdamW`): data parallelism, ZeRO-1, ZeRO-3, tensor parallelism and
TP + ZeRO-1.

The JAX package gets all of these from GSPMD: its Trainer hands jit the
shardings of parallel/tp.py's specs (mmd_tpu/training/trainer.py:462-621)
and XLA inserts the collectives. Here they are written out on
parallel/collectives.py, per leaf, following the same specs (so every rank
holds the JAX package's shard shapes; no DDP or FSDP, whose flat buffers
do not follow the per-leaf rule):

  * data parallelism (and TP alone): the gradients are mean-all-reduced
    over "data" (one all-reduce of their concatenation), then AdamW steps
    the rank's params, replicated over "data";
  * ZeRO-1 (and TP + ZeRO-1): the same mean, then AdamW steps the rank's
    rows of every leaf whose moments are split over "data" (a view into
    the param, so the moments exist for those rows only), and the updated
    rows are all-gathered back into the param;
  * ZeRO-3: the rank holds 1/dp of every divisible leaf; a step
    all-gathers the whole leaves (`working`), differentiates them,
    reduce-scatters each gradient into the rank's shard (and
    mean-all-reduces the leaves kept whole), and AdamW updates the shards.

On a (data, model) mesh without TP the state is replicated along "model".
Where the text encoder fine-tunes split over "model" (sequence or
pipeline parallel), each model rank's gradient of a text leaf is its part
of the whole: `Layout(model_partial=)` names those leaves, and the step
sums their gradients over "model" (one all-reduce) before anything
above. The other leaves' gradients are the same on every model rank and
are not summed.

Weight decay and the step count are make_optimizer's (torch's AdamW runs
on the blocks); Adam's count is replicated. `ShardedAdamW.state_dict` /
`load_state_dict` and `Layout.gather` / `load` speak the single-device
layout: every rank gathers (a collective), and a whole state is cut back
to the rank's blocks, so a checkpoint written under one mesh resumes on
one device or under another (training/trainer.Trainer.state_dict).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mmd_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from mmd_tpu_torch.parallel import collectives as C
from mmd_tpu_torch.parallel import tp as TP

_MOMENTS = ("exp_avg", "exp_avg_sq")


def train_specs(whole: nn.Module, data_size: int, tensor_parallel: bool,
                zero1: bool, zero3: bool) -> dict:
    """{"params": specs, "moments": specs} (JAX layout) of a whole tree
    under the Trainer's flags: parallel/tp.py's rules, all None for plain
    data parallelism."""
    if zero3:
        return TP.zero3_specs(whole, data_size)
    if tensor_parallel and zero1:
        return TP.tp_zero1_specs(whole, data_size)
    if tensor_parallel:
        s = TP.state_specs(whole)
        return {"params": s, "moments": dict(s)}
    if zero1:
        return TP.zero1_specs(whole, data_size)
    none = {n: (None,) * len(s) for n, s in TP.jax_shapes(whole).items()}
    return {"params": none, "moments": dict(none)}


class Layout:
    """The specs of the params and of the AdamW moments on a mesh, and the
    port dims they split (`param_dims`, `moment_dims`: {name: {axis:
    dim}}), for a whole tree's names in the optimizer's order;
    `model_partial`, the names whose gradients are partial sums over
    "model"."""

    def __init__(self, whole: nn.Module, mesh, specs: dict,
                 model_partial=()):
        self.mesh = mesh
        self.model_partial = set(model_partial)
        self.param_specs, self.moment_specs = specs["params"], specs["moments"]
        self.names = list(self.param_specs)
        self.param_dims = TP.port_dims(whole, self.param_specs)
        self.moment_dims = TP.port_dims(whole, self.moment_specs)
        self.data_size = mesh.shape[DATA_AXIS]
        self.zero3 = any(DATA_AXIS in d for d in self.param_dims.values())
        # ZeRO-1: the dim of a rank's param block whose rows it steps
        self.row_dims = {
            n: (None if DATA_AXIS in self.param_dims[n]
                else self.moment_dims[n].get(DATA_AXIS))
            for n in self.names}

    def shard(self, whole: nn.Module) -> nn.Module:
        """The rank's blocks of a whole tree, on the mesh's device."""
        return TP.shard_tree(whole, self.param_specs, self.mesh)

    def gather(self, params: nn.Module) -> nn.Module:
        """The whole tree from the ranks' blocks (a collective)."""
        return TP.gather_tree(params, self.param_specs, self.mesh)

    def load(self, params: nn.Module, state_dict: dict) -> None:
        """Cut a whole params state dict to the rank's blocks of `params`,
        in place."""
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(TP.local_block(state_dict[name],
                                       self.param_dims[name], self.mesh))

    def rows(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's rows of a param block that its moments cover (a
        view; the block itself where the moments are not split)."""
        dim = self.row_dims[name]
        if dim is None:
            return t
        return TP.local_block(t, {DATA_AXIS: dim}, self.mesh)


class ShardedAdamW:
    """AdamW over a rank's blocks of the state (see the module docstring).
    The step's gradients are read from the tree `working()` returned:
    the rank's params, or, under ZeRO-3, their gathered whole."""

    def __init__(self, params: nn.Module, layout: Layout, make_adamw):
        self.params, self.layout = params, layout
        self._leaves = [p if layout.row_dims[n] is None
                        else nn.Parameter(layout.rows(n, p.detach()))
                        for n, p in params.named_parameters()]
        self.inner = make_adamw(self._leaves)
        self._work: Optional[nn.Module] = None

    def working(self) -> nn.Module:
        """The tree a step differentiates (ZeRO-3: gathered anew)."""
        self._work = (self.layout.gather(self.params) if self.layout.zero3
                      else self.params)
        return self._work

    def step(self) -> None:
        lay, mesh = self.layout, self.layout.mesh
        work = dict(self._work.named_parameters())
        C.psum_([work[n].grad for n in lay.names if n in lay.model_partial],
                mesh, MODEL_AXIS)
        split, whole = [], []
        for name, leaf in zip(lay.names, self._leaves):
            dim = lay.param_dims[name].get(DATA_AXIS)
            (whole if dim is None else split).append((name, leaf, dim))
        # ZeRO-3: each gradient into the rank's shard
        grads = C.reduce_scatter_many([work[n].grad for n, _, _ in split],
                                      [d for _, _, d in split], mesh,
                                      DATA_AXIS)
        for (_, leaf, _), g in zip(split, grads):
            leaf.grad = g.div_(lay.data_size)
        grads = [work[n].grad for n, _, _ in whole]
        C.pmean_(grads, mesh, DATA_AXIS)
        for (name, leaf, _), g in zip(whole, grads):
            leaf.grad = lay.rows(name, g)     # ZeRO-1: the rank's rows
        self.inner.step()
        rows = [(p, leaf, lay.row_dims[n]) for n, p, leaf in
                zip(lay.names, self.params.parameters(), self._leaves)
                if leaf is not p]
        with torch.no_grad():
            for (p, _, _), t in zip(rows, C.all_gather_many(
                    [leaf.detach() for _, leaf, _ in rows],
                    [d for _, _, d in rows], mesh, DATA_AXIS)):
                p.copy_(t)
        self._work = None

    # -- the single-device layout ------------------------------------------

    def state_dict(self) -> dict:
        """The AdamW state of the whole params, as torch.optim.AdamW over
        them gives it (a collective)."""
        lay = self.layout
        sd = self.inner.state_dict()
        state = {i: dict(sd["state"].get(i, {}))
                 for i in range(len(lay.names))}
        for k in _MOMENTS:
            idx = [i for i in state if k in state[i]]
            whole = TP.gather_blocks(
                [state[i][k] for i in idx],
                [lay.moment_dims[lay.names[i]] for i in idx], lay.mesh)
            for i, t in zip(idx, whole):
                state[i][k] = t
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, state_dict: dict) -> None:
        """Load a whole AdamW state (the single-device layout)."""
        lay = self.layout
        state = {}
        for i, name in enumerate(lay.names):
            st = dict(state_dict["state"].get(i, {}))
            for k in _MOMENTS:
                if k in st:
                    st[k] = TP.local_block(st[k], lay.moment_dims[name],
                                           lay.mesh).clone()
            state[i] = st
        self.inner.load_state_dict({"state": state,
                                    "param_groups":
                                        state_dict["param_groups"]})

    def state_bytes(self) -> int:
        """Bytes of the rank's params and AdamW moments."""
        n = sum(p.numel() * p.element_size() for p in self.params.parameters())
        for st in self.inner.state.values():
            for k in _MOMENTS:
                if k in st:
                    n += st[k].numel() * st[k].element_size()
        return n
