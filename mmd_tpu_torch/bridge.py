"""Weight bridge: JAX parameter trees (numpy leaves) -> the port's modules.

The JAX package keeps params as nested dicts and lists. The port mirrors
them name for name (models/layers.ParamTree), so one walk maps both:
  {"w": (in, out), "b": (out,)}  -> nn.Linear (weight = w.T)
  {"w": (in, out)}                -> nn.Linear(bias=False)
  {"scale": (d,), "bias": (d,)}  -> nn.LayerNorm (weight, bias)
  list                            -> nn.ModuleList, item by item
  array (e.g. word / position / token_type embeddings, pos_embed)
                                  -> the parameter of the same name
Every name is checked both ways: a key the port lacks, a key the JAX tree
lacks, or a shape that differs raises. Leaves may be numpy or any array
`np.asarray` takes; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.deberta import DebertaConfig, init_deberta
from mmd_tpu_torch.models.fusion import init_fusion_params
from mmd_tpu_torch.models.swin import SwinConfig, init_swin
from mmd_tpu_torch.models.text_encoder import init_text_encoder
from mmd_tpu_torch.models.transformer import TransformerConfig
from mmd_tpu_torch.models.vit import ViTConfig, init_vit


def _copy(dst: torch.Tensor, src, where: str) -> None:
    arr = np.asarray(src, dtype=np.float32)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{where}: shape {arr.shape} does not match the "
                         f"port's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.tensor(arr))


def _check_keys(got, want, where: str) -> None:
    got, want = set(got), set(want)
    if got != want:
        raise KeyError(f"{where}: keys missing from the JAX tree "
                       f"{sorted(want - got)}, keys the port lacks "
                       f"{sorted(got - want)}")


def load_jax_tree(module: nn.Module, tree, where: str = "params") -> None:
    """Copy a JAX param tree into a port module of the same structure."""
    if isinstance(module, nn.Linear):
        if not isinstance(tree, Mapping):
            raise KeyError(f"{where}: a dict expected, got {type(tree)}")
        _check_keys(tree.keys(), ("w",) if module.bias is None else ("w", "b"),
                    where)
        _copy(module.weight, np.asarray(tree["w"]).T, f"{where}.w")
        if module.bias is not None:
            _copy(module.bias, tree["b"], f"{where}.b")
    elif isinstance(module, nn.LayerNorm):
        _check_keys(tree.keys(), ("scale", "bias"), where)
        _copy(module.weight, tree["scale"], f"{where}.scale")
        _copy(module.bias, tree["bias"], f"{where}.bias")
    elif isinstance(module, nn.ModuleList):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(module):
            raise KeyError(f"{where}: a list of {len(module)} entries "
                           f"expected")
        for i, (m, t) in enumerate(zip(module, tree)):
            load_jax_tree(m, t, f"{where}[{i}]")
    elif isinstance(module, L.ParamTree):
        if not isinstance(tree, Mapping):
            raise KeyError(f"{where}: a dict expected, got {type(tree)}")
        _check_keys(tree.keys(), module.keys(), where)
        for name in module.keys():
            child = module[name]
            if isinstance(child, nn.Parameter):
                _copy(child, tree[name], f"{where}.{name}")
            else:
                load_jax_tree(child, tree[name], f"{where}.{name}")
    else:
        raise TypeError(f"{where}: no JAX mapping for {type(module)}")


def fusion_from_jax(tree, cfg: ModelConfig) -> L.ParamTree:
    params = init_fusion_params(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "fusion")
    return params


def text_encoder_from_jax(tree, cfg: TransformerConfig) -> L.ParamTree:
    params = init_text_encoder(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "text_encoder")
    return params


def vit_from_jax(tree, cfg: ViTConfig) -> L.ParamTree:
    params = init_vit(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "vit")
    return params


def deberta_from_jax(tree, cfg: DebertaConfig) -> L.ParamTree:
    params = init_deberta(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "deberta")
    return params


def swin_from_jax(tree, cfg: SwinConfig) -> L.ParamTree:
    params = init_swin(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "swin")
    return params
