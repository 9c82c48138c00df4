"""Weight bridge: JAX parameter trees (numpy leaves) <-> the port's modules.

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
`np.asarray` takes; nothing here imports JAX. `to_jax_tree` walks the other
way (port module -> nested dicts and lists of float32 numpy arrays), so
tests can compare params, or grads (`grads=True`), after a training step.
`finetune_from_jax` loads a JAX fine-tuning state's joint params
{"fusion", "text", "vit"}; `to_jax_tree` walks its gradients back.
`captioner_from_jax` loads a captioner tree {"vit", "decoder"} and, for a
converted BLIP, "lm_head". `fakenet_from_jax` loads a FakeNet tree.
The ResNet's conv kernels are the one layout that differs: HWIO in the
JAX tree, OIHW (F.conv2d's) in the port; `resnet_from_jax` transposes
them, `resnet_to_jax` back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from mmd_tpu_torch.baselines.fakenet import FakeNetConfig, init_fakenet
from mmd_tpu_torch.core.config import ModelConfig
from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.captioner import CaptionerConfig, init_captioner
from mmd_tpu_torch.models.deberta import DebertaConfig, init_deberta
from mmd_tpu_torch.models.fusion import init_fusion_params
from mmd_tpu_torch.models.resnet import ResNetConfig, init_resnet
from mmd_tpu_torch.models.swin import SwinConfig, init_swin
from mmd_tpu_torch.models.text_encoder import (
    init_cross_encoder, init_text_encoder,
)
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


def to_jax_tree(module: nn.Module, grads: bool = False):
    """The JAX param tree of a port module, numpy leaves (the inverse of
    `load_jax_tree`); with grads=True the leaves are the params' .grad."""
    def leaf(p):
        t = p.grad if grads else p
        if t is None:
            raise ValueError("a parameter has no gradient")
        return t.detach().float().cpu().numpy()

    if isinstance(module, nn.Linear):
        out = {"w": leaf(module.weight).T.copy()}
        if module.bias is not None:
            out["b"] = leaf(module.bias)
        return out
    if isinstance(module, nn.LayerNorm):
        return {"scale": leaf(module.weight), "bias": leaf(module.bias)}
    if isinstance(module, nn.ModuleList):
        return [to_jax_tree(m, grads) for m in module]
    if isinstance(module, L.ParamTree):
        out = {}
        for name in module.keys():
            child = module[name]
            out[name] = (leaf(child) if isinstance(child, nn.Parameter)
                         else to_jax_tree(child, grads))
        return out
    raise TypeError(f"no JAX mapping for {type(module)}")


def fusion_from_jax(tree, cfg: ModelConfig) -> L.ParamTree:
    params = init_fusion_params(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "fusion")
    return params


def text_encoder_from_jax(tree, cfg: TransformerConfig) -> L.ParamTree:
    params = init_text_encoder(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "text_encoder")
    return params


def cross_encoder_from_jax(tree, cfg: TransformerConfig) -> L.ParamTree:
    """{"backbone", "scorer"} and, when the tree has one (a converted HF
    cross-encoder), "pooler"."""
    params = init_cross_encoder(torch.Generator().manual_seed(0), cfg,
                                pooler="pooler" in tree)
    load_jax_tree(params, tree, "cross_encoder")
    return params


_RESNET_CONVS = ("stem", "conv1", "conv2", "conv3", "proj")


def _resnet_convs(tree, perm):
    """The ResNet tree with every conv kernel transposed by `perm`."""
    def block(b):
        return {k: np.asarray(v).transpose(perm) if k in _RESNET_CONVS else v
                for k, v in b.items()}
    out = block({k: v for k, v in tree.items() if k != "blocks"})
    out["blocks"] = [block(b) for b in tree["blocks"]]
    return out


def resnet_from_jax(tree, cfg: ResNetConfig) -> L.ParamTree:
    """The JAX ResNet tree (HWIO kernels, a `blocks` list whose blocks may
    have proj/bn_proj) as the port's module (OIHW)."""
    if not isinstance(tree, Mapping) or "blocks" not in tree:
        raise KeyError("resnet: a dict with a blocks list expected")
    params = init_resnet(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, _resnet_convs(tree, (3, 2, 0, 1)), "resnet")
    return params


def resnet_to_jax(params: L.ParamTree):
    """The JAX ResNet tree of the port's module (the inverse of
    `resnet_from_jax`)."""
    return _resnet_convs(to_jax_tree(params), (2, 3, 1, 0))


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


def text_from_jax(tree, cfg) -> L.ParamTree:
    """A text encoder of either family, by its config."""
    if isinstance(cfg, DebertaConfig):
        return deberta_from_jax(tree, cfg)
    return text_encoder_from_jax(tree, cfg)


def image_from_jax(tree, cfg) -> L.ParamTree:
    """An image encoder of either family, by its config."""
    if isinstance(cfg, SwinConfig):
        return swin_from_jax(tree, cfg)
    return vit_from_jax(tree, cfg)


def finetune_from_jax(tree, model_cfg: ModelConfig, text_cfg,
                      vit_cfg) -> L.ParamTree:
    """The joint params of a JAX fine-tuning state (init_finetune_state's
    {"fusion", "text", "vit"}) as the port's fine-tuning params."""
    _check_keys(tree.keys(), ("fusion", "text", "vit"), "finetune")
    return L.ParamTree({"fusion": fusion_from_jax(tree["fusion"], model_cfg),
                        "text": text_from_jax(tree["text"], text_cfg),
                        "vit": image_from_jax(tree["vit"], vit_cfg)})


def captioner_from_jax(tree, cfg: CaptionerConfig) -> L.ParamTree:
    """A JAX captioner tree ({"vit", "decoder"}, and "lm_head" when it has
    BLIP's prediction head) as the port's captioner params."""
    params = init_captioner(torch.Generator().manual_seed(0), cfg,
                            lm_head="lm_head" in tree)
    load_jax_tree(params, tree, "captioner")
    return params


def fakenet_from_jax(tree, cfg: FakeNetConfig) -> L.ParamTree:
    """A JAX FakeNet tree (init_fakenet's) as the port's FakeNet params."""
    params = init_fakenet(torch.Generator().manual_seed(0), cfg)
    load_jax_tree(params, tree, "fakenet")
    return params
