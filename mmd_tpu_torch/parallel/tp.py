"""Tensor parallelism for encoder serving (counterpart of the encoder part
of mmd_tpu/parallel/tp.py).

The Megatron split over the mesh's "model" axis: q, k, v and ffn_in split
by column (each rank owns num_heads/tp heads end to end and 1/tp of the
FFN's hidden units), attn_out and ffn_out by row (each rank's partial
products are summed over the axis at the residual boundary, and the bias,
kept whole, is added after the sum). Embeddings, LayerNorms, the relative
position tables and the pooler stay replicated. `shard_encoder` copies
each rank's slice, and only that, to its device; the forward
(`tensor_parallel_encode`) is the models' own, given a `TensorParallel`
axis (models/transformer.encoder_layer, models/deberta.deberta_layer).

The JAX package leaves the partitioning to GSPMD on its jnp path; here the
local heads run the kernels on the rank's device (#1, and #10 at h/tp
heads of the same head dim), as a shard_map would. Activations between
blocks are replicated over the axis, so the output is (B, T, D) on every
rank with no final gather. The fusion-param rules (`state_specs`, ZeRO)
belong to multi-device training (ROADMAP A16b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from mmd_tpu_torch.core.mesh import MODEL_AXIS
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.parallel import collectives as C

_COL = "col"    # weight (out, in) split along out (dim 0), bias along dim 0
_ROW = "row"    # weight (out, in) split along in (dim 1), bias replicated

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
        return C.psum(y, self.mesh, self.axis)


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
