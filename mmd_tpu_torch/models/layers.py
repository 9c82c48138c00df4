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
Dropout takes an integer seed per site and runs ops/dropout.py: the
hand-written kernel on CUDA tensors, its plain version on CPU tensors, with
a backward that regenerates the mask from the seed. Where the JAX package
runs its fused bf16 MLP kernel (bf16, dropout active, both widths multiples
of 128, on the TPU), `mlp` runs ops/mlp.py's fused MLP on CUDA tensors
at the widths its kernels are built for (D 128 or 256):
the forward and backward kernels, with the same two masks as the unfused
path. The CPU keeps the unfused path, as the JAX package does off the TPU.

Under a mesh (`par`, parallel/tp.FusionParallel) `mlp` and `head_apply`
take their dropout seeds as `par.split` folds them; with tensor
parallelism they run on the rank's hidden slice: the column-split layer
reads its input through `par.tp.copy`, the row-split one sums its partial
products through `par.tp.reduce` (`row_linear`), and the dropout of the
rank's hidden slice (#5 on CUDA tensors) draws the rank's own mask.
"""

from __future__ import annotations

import copy
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmd_tpu_torch.ops import dropout as D
from mmd_tpu_torch.ops.mlp import fused_mlp, kernel_widths_ok


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


def shared_copy(tree: nn.Module) -> nn.Module:
    """A copy of a param tree whose modules and parameters are new objects
    over the same tensors: placing, slicing or replacing a leaf of the copy
    leaves `tree` as it was, and nothing is copied until a leaf moves."""
    memo = {id(b): b for b in tree.buffers()}
    memo.update({id(p): nn.Parameter(p.detach(),
                                     requires_grad=p.requires_grad)
                 for p in tree.parameters()})
    return copy.deepcopy(tree, memo)


def dtype_of(name: str) -> torch.dtype:
    """Config dtype names ("bfloat16", "float32") -> torch dtypes."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def run_layers(fn, layers, h: torch.Tensor, *args, remat: bool
               ) -> torch.Tensor:
    """h through fn(p, h, *args) for each layer p, each under
    torch.utils.checkpoint when `remat` and autograd records (the layer
    runs again in the backward)."""
    remat = remat and torch.is_grad_enabled()
    for p in layers:
        h = (checkpoint(fn, p, h, *args, use_reentrant=False) if remat
             else fn(p, h, *args))
    return h


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


def row_linear(lin: nn.Linear, x: torch.Tensor,
               dtype: torch.dtype = torch.float32, tp=None) -> torch.Tensor:
    """`linear` of a projection whose input features are split over the
    ranks of a tensor-parallel axis (`tp`, parallel/tp.TensorParallel):
    each rank's partial product in the compute dtype (bf16-rounded under
    bf16), the partials summed over the axis in fp32, then the whole bias,
    added once. tp None: `linear`."""
    if tp is None:
        return linear(lin, x, dtype)
    y = tp.reduce(F.linear(x.to(dtype), lin.weight.to(dtype)).float())
    if lin.bias is not None:
        y = y + lin.bias.float()
    return y.to(dtype)


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

def dropout(x: torch.Tensor, rate: float, seed: Optional[int],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout with the mask of `seed` (ops/dropout.py)."""
    if deterministic or rate <= 0.0:
        return x
    if seed is None:
        raise ValueError("dropout requires a seed when non-deterministic")
    return D.dropout(x, rate, seed)


# -- MLP ----------------------------------------------------------------------

def mlp_init(gen: torch.Generator, embed_dim: int, mlp_ratio: float = 4.0
             ) -> ParamTree:
    hidden = int(embed_dim * mlp_ratio)
    return ParamTree({"fc1": linear_init(gen, embed_dim, hidden),
                      "fc2": linear_init(gen, hidden, embed_dim)})


def needs_fused_mlp(dtype: torch.dtype, dropout_rate: float,
                    deterministic: bool, device: torch.device, embed_dim: int,
                    hidden: int) -> bool:
    """The JAX package's rule for its fused MLP kernel (layers.py:121-128),
    with "backend is TPU" read as "tensors on CUDA": bf16, dropout active,
    both widths multiples of 128 -- with D up to the kernels' cap
    (ops/mlp.py MAX_WIDTH, 1024). A wider D takes the unfused composition
    (ROADMAP §C), which draws the same masks, so the step computes the
    same function."""
    return (dropout_rate > 0.0 and not deterministic
            and dtype == torch.bfloat16 and torch.device(device).type == "cuda"
            and kernel_widths_ok(embed_dim, hidden))


def mlp(params: ParamTree, x: torch.Tensor, dropout_rate: float = 0.0,
        seed: Optional[int] = None, deterministic: bool = True,
        dtype: torch.dtype = torch.float32, par=None) -> torch.Tensor:
    """GELU MLP (reference layers.py:5-21, torch nn.GELU = erf-exact).

    Under float32 the erf form is used (parity with the reference); under
    bfloat16 the tanh approximation, as the JAX package does: its deviation
    from erf-GELU (~5e-4 relative) is below bf16 resolution (~4e-3). Its two
    dropouts take seeds split from `seed`, as the JAX package splits its
    key. Where `needs_fused_mlp` holds, the block runs as ops/mlp.fused_mlp
    (kernels #3/#4), which draws the same two masks from the same seeds.

    `par` (parallel/tp.FusionParallel): the two seeds are split from
    `seed` and folded by `par.split`; with tensor parallelism fc1 is the
    rank's columns and fc2 its rows (the local F routes the fused
    kernels)."""
    tp = par.tp if par is not None else None
    seeds = None if seed is None else tuple(
        par.split(seed, 2) if par is not None else D.split_seed(seed, 2))
    if needs_fused_mlp(dtype, dropout_rate, deterministic, x.device,
                       x.shape[-1], params["fc1"].weight.shape[0]):
        fc1, fc2 = params["fc1"], params["fc2"]
        return fused_mlp(x, fc1.weight.T, fc1.bias, fc2.weight.T, fc2.bias,
                         dropout_rate, seeds, dtype,
                         tp_mesh=par.mesh if tp is not None else None)
    s1, s2 = seeds or (None, None)
    if tp is not None:
        x = tp.copy(x)
    h = linear(params["fc1"], x, dtype)
    h = F.gelu(h, approximate="tanh" if dtype == torch.bfloat16 else "none")
    h = dropout(h, dropout_rate, s1, deterministic)
    h = row_linear(params["fc2"], h, dtype, tp)
    return dropout(h, dropout_rate, s2, deterministic)


# -- Classifier-head MLPs (ReLU stacks; reference model.py:252-288) -----------

def head_init(gen: torch.Generator, dims: list[int]) -> ParamTree:
    return ParamTree({f"fc{i}": linear_init(gen, dims[i], dims[i + 1])
                      for i in range(len(dims) - 1)})


def head_apply(params: ParamTree, x: torch.Tensor, dropout_rate: float = 0.0,
               seed: Optional[int] = None, deterministic: bool = True,
               dtype: torch.dtype = torch.float32, par=None) -> torch.Tensor:
    """Linear -> ReLU -> Dropout between every pair; final Linear bare. The
    dropouts take seeds split from `seed`, folded by `par.split` under a
    mesh (`par`). With tensor parallelism fc0 is the rank's columns and fc1
    its rows (summed over the model axis), so the dropout after fc0 drops
    the rank's slice; later layers run replicated."""
    tp = par.tp if par is not None else None
    n = len(params.keys())
    if par is not None:
        seeds = par.split(seed, n)
    else:
        seeds = D.split_seed(seed, n) if seed is not None else [None] * n
    for i in range(n):
        if tp is not None and i == 0:
            x = linear(params["fc0"], tp.copy(x), dtype)
        elif tp is not None and i == 1:
            x = row_linear(params["fc1"], x, dtype, tp)
        else:
            x = linear(params[f"fc{i}"], x, dtype)
        if i < n - 1:
            x = dropout(torch.relu(x), dropout_rate, seeds[i], deterministic)
    return x


# -- HF state dicts -------------------------------------------------------------
# The HF loaders of the encoder modules gather {port state-dict name:
# tensor} from a HF state dict and load it with `load_tensors`. nn.Linear
# and nn.LayerNorm keep HF's own names and HF's (out, in) weight layout, so
# a module maps onto a HF module weight for weight, with no transpose.

def hf_tensor(state_dict: Mapping, name: str) -> torch.Tensor:
    """One entry of a HF state dict (torch or numpy values) as a float32
    CPU tensor; a missing entry raises KeyError naming it."""
    if name not in state_dict:
        raise KeyError(f"the HF state dict has no {name!r}")
    value = state_dict[name]
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(value, dtype=np.float32))


class HFPrefixed(Mapping):
    """The entries of a HF state dict under `prefix`, by their names
    without it (a task wrapper's "bert." or "mpnet."). Reads go through to
    the state dict itself, so a reader that records them sees them."""

    def __init__(self, state_dict: Mapping, prefix: str):
        self.state_dict, self.prefix = state_dict, prefix

    def __getitem__(self, name: str):
        return self.state_dict[self.prefix + name]

    def __iter__(self):
        n = len(self.prefix)
        return (k[n:] for k in self.state_dict if k.startswith(self.prefix))

    def __len__(self) -> int:
        return sum(1 for _ in self)

    def __contains__(self, name) -> bool:
        return self.prefix + name in self.state_dict


def hf_modules(state_dict: Mapping, pairs: Mapping[str, str],
               bias: bool = True) -> dict[str, torch.Tensor]:
    """{port module: HF module} -> {port name: tensor} for the weight, and
    with `bias` the bias, of each pair."""
    leaves = ("weight", "bias") if bias else ("weight",)
    return {f"{ours}.{leaf}": hf_tensor(state_dict, f"{theirs}.{leaf}")
            for ours, theirs in pairs.items() for leaf in leaves}


def load_tensors(module: nn.Module, tensors: Mapping[str, torch.Tensor],
                 where: str) -> nn.Module:
    """Copy `tensors` into `module` by state-dict name: every name of the
    module, no other, each of the module's shape."""
    own = module.state_dict()
    missing = sorted(set(own) - set(tensors))
    extra = sorted(set(tensors) - set(own))
    if missing or extra:
        raise KeyError(f"{where}: names missing {missing}, names the module "
                       f"lacks {extra}")
    for name, t in tensors.items():
        if tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"{where}.{name}: shape {tuple(t.shape)} does "
                             f"not match the module's "
                             f"{tuple(own[name].shape)}")
    module.load_state_dict(tensors)
    return module
