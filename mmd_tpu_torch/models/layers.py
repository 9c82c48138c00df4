"""Building blocks: Linear, LayerNorm, MLP, classifier heads.

Counterpart of mmd_tpu/models/layers.py. Parameters live in modules that
mirror the JAX param trees name for name (`ParamTree`, `nn.Linear`,
`nn.LayerNorm`, `nn.ModuleList`); the forward functions take those modules
and run the same math. Params are float32; matmuls run in the configured
compute dtype, with the weights cast per matmul; LayerNorm statistics are
float32.

Math parity targets (reference src/model/layers.py):
  MLP   = Linear(D -> D*ratio) -> GELU(exact) -> Dropout -> Linear(-> D) -> Dropout
  init  = Xavier-uniform weights, zero bias; LN scale=1 bias=0
          (reference model.py:416-424)
Dropout is a training feature: only its deterministic form is ported.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """One dict of a JAX param tree as a module. Children are sub-trees,
    `nn.Linear`, `nn.LayerNorm`, `nn.ModuleList` or bare parameters, under
    the JAX key names; `tree[name]` reads one."""

    def __init__(self, children: Mapping[str, object]):
        super().__init__()
        for name, child in children.items():
            if isinstance(child, torch.Tensor) and not isinstance(
                    child, nn.Parameter):
                child = nn.Parameter(child)
            setattr(self, name, child)

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._modules or name in self._parameters

    def keys(self) -> list[str]:
        return [*self._modules, *self._parameters]


def dtype_of(name: str) -> torch.dtype:
    """Config dtype names ("bfloat16", "float32") -> torch dtypes."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def xavier_uniform(gen: torch.Generator, in_dim: int, out_dim: int
                   ) -> torch.Tensor:
    """(in_dim, out_dim) float32, the JAX layout."""
    bound = (6.0 / (in_dim + out_dim)) ** 0.5
    return torch.empty(in_dim, out_dim).uniform_(-bound, bound, generator=gen)


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * std


# -- Linear -------------------------------------------------------------------

def linear_init(gen: torch.Generator, in_dim: int, out_dim: int,
                bias: bool = True) -> nn.Linear:
    """bias=False gives the JAX package's bias-free {"w"} projections
    (Swinv2's key, position-bias output and patch-merge reduction)."""
    lin = nn.utils.skip_init(nn.Linear, in_dim, out_dim, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(xavier_uniform(gen, in_dim, out_dim).T)
        if bias:
            lin.bias.zero_()
    return lin


def linear(lin: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    if lin.bias is None:
        return y
    return (y.float() + lin.bias.float()).to(dtype)


# -- LayerNorm ----------------------------------------------------------------

def layernorm_init(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim)


def layernorm(ln: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """fp32 statistics, result cast back to x's dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), ln.weight.float(),
                     ln.bias.float(), eps)
    return y.to(x.dtype)


# -- Dropout ------------------------------------------------------------------

def dropout(x: torch.Tensor, rate: float, deterministic: bool) -> torch.Tensor:
    if deterministic or rate <= 0.0:
        return x
    raise NotImplementedError(
        "dropout is part of the training slice, not ported yet")


# -- MLP ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, embed_dim: int, mlp_ratio: float = 4.0
             ) -> ParamTree:
    hidden = int(embed_dim * mlp_ratio)
    return ParamTree({"fc1": linear_init(gen, embed_dim, hidden),
                      "fc2": linear_init(gen, hidden, embed_dim)})


def mlp(params: ParamTree, x: torch.Tensor, dropout_rate: float = 0.0,
        deterministic: bool = True, dtype: torch.dtype = torch.float32
        ) -> torch.Tensor:
    """GELU MLP (reference layers.py:5-21, torch nn.GELU = erf-exact).

    Under float32 the erf form is used (parity with the reference); under
    bfloat16 the tanh approximation, as the JAX package does: its deviation
    from erf-GELU (~5e-4 relative) is below bf16 resolution (~4e-3)."""
    h = linear(params["fc1"], x, dtype)
    h = F.gelu(h, approximate="tanh" if dtype == torch.bfloat16 else "none")
    h = dropout(h, dropout_rate, deterministic)
    h = linear(params["fc2"], h, dtype)
    return dropout(h, dropout_rate, deterministic)


# -- Classifier-head MLPs (ReLU stacks; reference model.py:252-288) -----------

def head_init(gen: torch.Generator, dims: list[int]) -> ParamTree:
    return ParamTree({f"fc{i}": linear_init(gen, dims[i], dims[i + 1])
                      for i in range(len(dims) - 1)})


def head_apply(params: ParamTree, x: torch.Tensor, dropout_rate: float = 0.0,
               deterministic: bool = True,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Linear -> ReLU -> Dropout between every pair; final Linear bare."""
    n = len(params.keys())
    for i in range(n):
        x = linear(params[f"fc{i}"], x, dtype)
        if i < n - 1:
            x = dropout(torch.relu(x), dropout_rate, deterministic)
    return x
