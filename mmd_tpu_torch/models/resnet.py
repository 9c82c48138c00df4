"""ResNet50 feature extractor for image-to-image retrieval (counterpart of
mmd_tpu/models/resnet.py).

The reference uses torchvision resnet50 minus the FC head as a frozen
2048-d global feature extractor (reference im2im_retrieval.py:12-42). The
same architecture as the JAX package's: bottleneck blocks with the stride
on conv2, inference-mode batchnorm folded to scale and shift, convolutions
in the compute dtype with fp32 accumulation (`F.conv2d`, as the JAX
package's are `lax.conv_general_dilated`), fp32 global mean pool.

Images enter NHWC, as in the JAX package; conv weights are OIHW (the JAX
tree's HWIO, transposed by bridge.resnet_from_jax). Padding follows XLA's
"SAME" rule, which is not PyTorch's symmetric `padding=k // 2`: the total
is max((ceil(n / s) - 1) s + k - n, 0) and the odd pixel goes to the high
end, so the 7x7 stride-2 stem on 224 pads (2, 3) and a 3x3 stride-2 conv
on an even input (0, 1). Converted torchvision weights therefore do not
reproduce torchvision's own features, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmd_tpu_torch.models import layers as L


@dataclasses.dataclass
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)     # resnet50
    width: int = 64
    compute_dtype: str = "bfloat16"

    @property
    def feature_dim(self) -> int:
        # final stage channels x bottleneck expansion (2048 for resnet50)
        return self.width * (2 ** (len(self.stage_sizes) - 1)) * 4


RESNET_TEST = ResNetConfig(stage_sizes=(1, 1), width=8)


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int
               ) -> torch.Tensor:
    """(cout, cin, kh, kw), He-normal."""
    return L.normal(gen, (cout, cin, kh, kw), (2.0 / (kh * kw * cin)) ** 0.5)


def _bn_init(c: int) -> L.ParamTree:
    # inference-mode BN folded to scale/shift
    return L.ParamTree({"scale": torch.ones(c), "shift": torch.zeros(c)})


def _bottleneck_init(gen: torch.Generator, cin: int, cmid: int,
                     stride: int) -> L.ParamTree:
    cout = cmid * 4
    p = {"conv1": _conv_init(gen, 1, 1, cin, cmid), "bn1": _bn_init(cmid),
         "conv2": _conv_init(gen, 3, 3, cmid, cmid), "bn2": _bn_init(cmid),
         "conv3": _conv_init(gen, 1, 1, cmid, cout), "bn3": _bn_init(cout)}
    if stride != 1 or cin != cout:
        p["proj"] = _conv_init(gen, 1, 1, cin, cout)
        p["bn_proj"] = _bn_init(cout)
    return L.ParamTree(p)


def block_strides(cfg: ResNetConfig) -> list[int]:
    """Per-block strides: 2 on the first block of every stage but the
    first."""
    return [2 if (b == 0 and stage > 0) else 1
            for stage, n in enumerate(cfg.stage_sizes) for b in range(n)]


def _block_widths(cfg: ResNetConfig) -> list[tuple[int, int]]:
    """(cin, cmid) of each block."""
    out, cin = [], cfg.width
    for stage, n in enumerate(cfg.stage_sizes):
        cmid = cfg.width * (2 ** stage)
        for _ in range(n):
            out.append((cin, cmid))
            cin = cmid * 4
    return out


def init_resnet(gen: torch.Generator, cfg: ResNetConfig = ResNetConfig()
                ) -> L.ParamTree:
    blocks = [_bottleneck_init(gen, cin, cmid, stride) for (cin, cmid), stride
              in zip(_block_widths(cfg), block_strides(cfg))]
    return L.ParamTree({"stem": _conv_init(gen, 7, 7, 3, cfg.width),
                        "bn_stem": _bn_init(cfg.width),
                        "blocks": nn.ModuleList(blocks)})


def same_padding(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0
              ) -> torch.Tensor:
    (hl, hh), (wl, wh) = (same_padding(n, k, s) for n in x.shape[2:])
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int,
          dtype: torch.dtype) -> torch.Tensor:
    """NCHW conv in `dtype` (fp32 accumulation), SAME padding."""
    x = _pad_same(x.to(dtype), w.shape[-1], stride)
    return F.conv2d(x, w.to(dtype), stride=stride)


def _bn(p: L.ParamTree, x: torch.Tensor) -> torch.Tensor:
    c = (1, -1, 1, 1)
    return (x.float() * p["scale"].view(c) + p["shift"].view(c)).to(x.dtype)


def resnet_features(params: L.ParamTree, images: torch.Tensor,
                    cfg: ResNetConfig = ResNetConfig()) -> torch.Tensor:
    """(B, H, W, 3) normalized float -> (B, feature_dim) f32 global
    features."""
    dtype = L.dtype_of(cfg.compute_dtype)
    x = images.permute(0, 3, 1, 2)                   # NCHW view of NHWC
    x = torch.relu(_bn(params["bn_stem"], _conv(x, params["stem"], 2, dtype)))
    x = F.max_pool2d(_pad_same(x, 3, 2, -float("inf")), 3, 2)
    for p, stride in zip(params["blocks"], block_strides(cfg)):
        r = x
        h = torch.relu(_bn(p["bn1"], _conv(x, p["conv1"], 1, dtype)))
        h = torch.relu(_bn(p["bn2"], _conv(h, p["conv2"], stride, dtype)))
        h = _bn(p["bn3"], _conv(h, p["conv3"], 1, dtype))
        if "proj" in p:
            r = _bn(p["bn_proj"], _conv(x, p["proj"], stride, dtype))
        x = torch.relu(h + r)
    return x.float().mean(dim=(2, 3))


def load_torchvision_state_dict(state_dict: Mapping,
                                cfg: ResNetConfig = ResNetConfig()
                                ) -> L.ParamTree:
    """A torchvision resnet state dict (torch or numpy values) as the
    port's params: conv weights as they are (OIHW), BN running statistics
    folded into scale and shift in float32 numpy, as the JAX loader folds
    them. The fc head and num_batches_tracked are not read."""
    def arr(name):
        return L.hf_tensor(state_dict, name).numpy()

    def bn(name, eps=1e-5):
        g, b = arr(f"{name}.weight"), arr(f"{name}.bias")
        mean, var = arr(f"{name}.running_mean"), arr(f"{name}.running_var")
        scale = g / np.sqrt(var + eps)
        return scale, b - mean * scale

    names = {"stem": "conv1", "bn_stem": "bn1"}
    blocks = [(s, b) for s, n in enumerate(cfg.stage_sizes) for b in range(n)]
    for i, (stage, b) in enumerate(blocks):
        pre = f"layer{stage + 1}.{b}"
        for j in (1, 2, 3):
            names[f"blocks.{i}.conv{j}"] = f"{pre}.conv{j}"
            names[f"blocks.{i}.bn{j}"] = f"{pre}.bn{j}"
        if f"{pre}.downsample.0.weight" in state_dict:
            names[f"blocks.{i}.proj"] = f"{pre}.downsample.0"
            names[f"blocks.{i}.bn_proj"] = f"{pre}.downsample.1"
    tensors = {}
    for ours, theirs in names.items():
        if ours.rsplit(".", 1)[-1].startswith("bn"):
            tensors[f"{ours}.scale"], tensors[f"{ours}.shift"] = bn(theirs)
        else:
            tensors[ours] = arr(f"{theirs}.weight")
    params = init_resnet(torch.Generator().manual_seed(0), cfg)
    return L.load_tensors(params, {k: torch.from_numpy(np.ascontiguousarray(v))
                                   for k, v in tensors.items()}, "resnet")
