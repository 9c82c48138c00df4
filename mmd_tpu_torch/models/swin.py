"""Swinv2 image encoder, serving forward (counterpart of
mmd_tpu/models/swin.py).

The reference embeds images with HF microsoft/swinv2-base-patch4-window8-256
and keeps last_hidden_state (B, 64, 1024). Same math as the JAX package:
cosine attention on L2-normalized q/k with a per-head clamped logit scale;
post-norm residual blocks; a bias-free key projection; the continuous
position bias MLP on a log-spaced coordinate table, 16 * sigmoid; patch
merging [x0; x1; x2; x3] -> Linear(4C -> 2C, no bias) -> LayerNorm; windows
that shrink to the resolution; and the shifted-window mask added twice, as
HF's Swinv2SelfAttention does.

Two paths per block, chosen as the JAX package chooses them:
  * fused_attn and a geometry `ops.swin_attention.fused_ok` admits: the
    window-major (nW, B, n, C) layout, and then
      - for serving, `swin_window_attention_infer` on the raw q, k (the
        CUDA kernel #7 normalizes them; it has no backward), or
      - with fused_train (fine-tuning), `swin_window_attention`, the
        differentiable kernels #8/#9: q and k are normalized and scaled
        here, where autograd differentiates them, and the bias (the
        continuous position bias MLP's output) takes its gradient dbias;
  * otherwise the explicit batch-major path.
fused_ln routes every LayerNorm through `ops.ln.fused_layernorm` (the
residual add inside it) instead of `layers.layernorm` followed by the add;
remat turns it off, as in the JAX package, and recomputes each block in
the backward (torch.utils.checkpoint).

The patch embedding is patchify + one linear, as in the JAX package (no
Conv2d, which cuDNN runs in TF32). The HF converters arrive with a later
slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmd_tpu_torch.models import layers as L
from mmd_tpu_torch.models.vit import patchify
from mmd_tpu_torch.ops.ln import fused_layernorm
from mmd_tpu_torch.ops.swin_attention import (
    fused_ok, swin_window_attention, swin_window_attention_infer,
)


@dataclasses.dataclass
class SwinConfig:
    image_size: int = 256
    patch_size: int = 4
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    num_heads: tuple = (4, 8, 16, 32)
    window_size: int = 8
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    pretrained_window_sizes: tuple = (0, 0, 0, 0)
    compute_dtype: str = "bfloat16"
    fused_attn: bool = True          # window attention through the kernel
    remat: bool = False              # recompute each block in the backward
    # the differentiable window-attention kernels (#8/#9) on the fused
    # path, for fine-tuning; off, the fused path is the serving kernel (#7)
    # and the trainer takes the explicit path when fine-tuning, as the JAX
    # package does
    fused_train: bool = False
    fused_ln: bool = True            # LayerNorms through the kernel

    def __post_init__(self):
        self.depths = tuple(self.depths)
        self.num_heads = tuple(self.num_heads)
        self.pretrained_window_sizes = tuple(self.pretrained_window_sizes)

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def hidden_size(self) -> int:
        """Final-stage channel dim (1024 for swinv2-base)."""
        return int(self.embed_dim * 2 ** (self.num_stages - 1))

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        """Output sequence length (64 for 256px/patch4/4 stages)."""
        return (self.grid_size // 2 ** (self.num_stages - 1)) ** 2

    def stage_dim(self, s: int) -> int:
        return int(self.embed_dim * 2 ** s)

    def stage_res(self, s: int) -> int:
        return self.grid_size // 2 ** s

    def stage_window_shift(self, s: int, block: int) -> tuple[int, int]:
        """(window, shift) after HF's _compute_window_shift shrink rule."""
        res = self.stage_res(s)
        window = min(res, self.window_size)
        shift = 0 if (block % 2 == 0 or res <= window) else window // 2
        return window, shift


SWIN_BASE_256 = SwinConfig()
SWIN_TEST = SwinConfig(image_size=32, patch_size=4, embed_dim=16,
                       depths=(2, 2), num_heads=(2, 4), window_size=4,
                       pretrained_window_sizes=(0, 0),
                       compute_dtype="float32")


# -- static tables (the port's own copies of the JAX package's) ----------------

def relative_coords_table(window: int, pretrained_window: int) -> np.ndarray:
    """(1, 2w-1, 2w-1, 2) log-spaced normalized coords (HF
    Swinv2SelfAttention.__init__)."""
    rel = np.arange(-(window - 1), window, dtype=np.float32)
    table = np.stack(np.meshgrid(rel, rel, indexing="ij"), axis=-1)[None]
    denom = (pretrained_window - 1) if pretrained_window > 0 else (window - 1)
    if denom > 0:
        table = table / denom
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.astype(np.float32)


def relative_position_index(window: int) -> np.ndarray:
    """(w*w, w*w) indices into the flattened (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))          # (2, w, w)
    flat = coords.reshape(2, -1)                            # (2, w*w)
    rel = flat[:, :, None] - flat[:, None, :]               # (2, n, n)
    rel = rel.transpose(1, 2, 0).copy()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int32)


def shift_attn_mask(res: int, window: int, shift: int) -> Optional[np.ndarray]:
    """(nW, w*w, w*w) additive mask (0 / -100) for shifted windows (HF
    Swinv2Layer.get_attn_mask). None when shift == 0."""
    if shift == 0:
        return None
    img = np.zeros((res, res), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    nw = res // window
    win = img.reshape(nw, window, nw, window).transpose(0, 2, 1, 3)
    win = win.reshape(-1, window * window)                  # (nW, w*w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# -- init ----------------------------------------------------------------------

def _init_block(gen: torch.Generator, dim: int, heads: int,
                mlp_ratio: float) -> L.ParamTree:
    inter = int(dim * mlp_ratio)
    return L.ParamTree({
        "q": L.linear_init(gen, dim, dim),
        "k": L.linear_init(gen, dim, dim, bias=False),      # no bias (v2)
        "v": L.linear_init(gen, dim, dim),
        "logit_scale": torch.full((heads,), math.log(10.0)),
        "cpb1": L.linear_init(gen, 2, 512),
        "cpb2": L.linear_init(gen, 512, heads, bias=False),
        "attn_out": L.linear_init(gen, dim, dim),
        "ln1": L.layernorm_init(dim),
        "ffn_in": L.linear_init(gen, dim, inter),
        "ffn_out": L.linear_init(gen, inter, dim),
        "ln2": L.layernorm_init(dim),
    })


def init_swin(gen: torch.Generator, cfg: SwinConfig) -> L.ParamTree:
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    stages = []
    for s in range(cfg.num_stages):
        dim = cfg.stage_dim(s)
        stage = {"blocks": nn.ModuleList(
            _init_block(gen, dim, cfg.num_heads[s], cfg.mlp_ratio)
            for _ in range(cfg.depths[s]))}
        if s < cfg.num_stages - 1:
            stage["downsample"] = L.ParamTree({
                "reduction": L.linear_init(gen, 4 * dim, 2 * dim, bias=False),
                "norm": L.layernorm_init(2 * dim),
            })
        stages.append(L.ParamTree(stage))
    return L.ParamTree({
        "patch_embed": L.linear_init(gen, patch_dim, cfg.embed_dim),
        "embed_ln": L.layernorm_init(cfg.embed_dim),
        "stages": nn.ModuleList(stages),
        "ln_final": L.layernorm_init(cfg.hidden_size),
    })


# -- window layouts ------------------------------------------------------------

def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, w*w, C)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """(B * nW, w*w, C) -> (B, H, W, C)."""
    c = x.shape[-1]
    x = x.reshape(-1, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, wd, c)


def _window_partition_wm(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> window-major (nW, B, w*w, C), the kernel's layout."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c).permute(1, 3, 0, 2, 4, 5)
    return x.reshape(-1, b, w * w, c)


def _window_reverse_wm(x: torch.Tensor, w: int, h: int, wd: int
                       ) -> torch.Tensor:
    """window-major (nW, B, w*w, C) -> (B, H, W, C)."""
    _, b, _, c = x.shape
    x = x.reshape(h // w, wd // w, b, w, w, c).permute(2, 0, 3, 1, 4, 5)
    return x.reshape(b, h, wd, c)


# -- forward -------------------------------------------------------------------

def _position_bias(bp: L.ParamTree, window: int, pretrained_window: int,
                   heads: int) -> torch.Tensor:
    """(heads, w*w, w*w) fp32 continuous relative position bias."""
    dev = bp["logit_scale"].device
    table = torch.from_numpy(relative_coords_table(window, pretrained_window)
                             ).to(dev)
    h = torch.relu(L.linear(bp["cpb1"], table))
    h = L.linear(bp["cpb2"], h)                             # (1,2w-1,2w-1,H)
    idx = torch.from_numpy(relative_position_index(window).reshape(-1)
                           ).to(dev, torch.long)
    n = window * window
    bias = h.reshape(-1, heads)[idx].reshape(n, n, heads)
    return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))


def _logit_scale(bp: L.ParamTree) -> torch.Tensor:
    """(heads,) exp(min(logit_scale, ln 100)), fp32."""
    return torch.exp(torch.clamp(bp["logit_scale"].float(),
                                 max=math.log(1.0 / 0.01)))


def _cosine_window_attention(bp: L.ParamTree, x: torch.Tensor, heads: int,
                             bias: torch.Tensor, mask: Optional[torch.Tensor],
                             dtype) -> torch.Tensor:
    """Explicit path: x (BW, n, C) batch-major windows -> (BW, n, C)."""
    bw, n, c = x.shape
    dh = c // heads
    q = L.linear(bp["q"], x, dtype)
    k = L.linear(bp["k"], x, dtype)
    v = L.linear(bp["v"], x, dtype)

    def split(t):
        return t.reshape(bw, n, heads, dh).transpose(1, 2)

    qh = split(q).float()
    kh = split(k).float()
    qh = qh / qh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kh = kh / kh.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    scores = qh.to(dtype).float() @ kh.to(dtype).float().transpose(-1, -2)
    scores = scores * _logit_scale(bp)[None, :, None, None]
    scores = scores + bias[None]
    if mask is not None:
        # window index = b * nW + w: tiling the (nW, n, n) mask over the
        # batch lines each window up with its region mask
        m = mask.repeat(bw // mask.shape[0], 1, 1)
        scores = scores + 2.0 * m[:, None]                  # HF adds it twice
    probs = torch.softmax(scores, dim=-1)
    ctx = (probs.to(dtype).float() @ split(v).float()).to(dtype)
    ctx = ctx.transpose(1, 2).reshape(bw, n, c)
    return L.linear(bp["attn_out"], ctx, dtype)


_LOG2E = 1.4426950408889634


def _cosine_window_attention_fused(bp: L.ParamTree, x: torch.Tensor,
                                   heads: int, bias: torch.Tensor,
                                   mask: Optional[torch.Tensor], dtype,
                                   differentiable: bool) -> torch.Tensor:
    """Kernel path: x window-major (nW, B, n, C) -> (nW, B, n, C).

    Serving (differentiable=False): the kernel takes the raw q/k and
    normalizes them itself; the per-window bias is the position bias plus
    twice the shift mask, or the position bias alone, shared by every
    window, when there is no shift.

    Fine-tuning (differentiable=True, the JAX package's counterpart with
    the same flag): q and k are L2-normalized per head here, q scaled by
    the clamped logit scale times log2(e); the bias goes to the log2
    domain and is broadcast to every window; `swin_window_attention`
    differentiates all of them."""
    nw, b, n, c = x.shape
    q = L.linear(bp["q"], x, dtype)
    k = L.linear(bp["k"], x, dtype)
    v = L.linear(bp["v"], x, dtype)
    if differentiable:
        def nrm(t):
            th = t.reshape(nw, b, n, heads, c // heads).float()
            return th / th.norm(dim=-1, keepdim=True).clamp_min(1e-12)

        qh = (nrm(q) * (_logit_scale(bp) * _LOG2E)[:, None]
              ).reshape(nw, b, n, c).to(dtype)
        kh = nrm(k).reshape(nw, b, n, c).to(dtype)
        tot = bias * _LOG2E
        tot = (tot.expand(nw, heads, n, n) if mask is None
               else tot[None] + (2.0 * _LOG2E) * mask[:, None])
        out = swin_window_attention(qh, kh, v, tot.contiguous(), heads)
    else:
        tot = bias[None] if mask is None else bias[None] + 2.0 * mask[:, None]
        # the position bias keeps the strides of the permute it came from
        out = swin_window_attention_infer(q, k, v, tot.contiguous(),
                                          _logit_scale(bp), heads)
    return L.linear(bp["attn_out"], out, dtype)


def _block(bp: L.ParamTree, x: torch.Tensor, res: int, heads: int,
           window: int, shift: int, pretrained_window: int, eps: float,
           dtype, fused: bool, fused_ln: bool, fused_train: bool
           ) -> torch.Tensor:
    """One Swinv2 block on (B, res*res, C). Post-norm residual order."""
    b, _, c = x.shape
    shortcut = x
    h = x.reshape(b, res, res, c)
    if shift > 0:
        h = torch.roll(h, (-shift, -shift), dims=(1, 2))
    bias = _position_bias(bp, window, pretrained_window, heads)
    mask = shift_attn_mask(res, window, shift)
    mask = torch.from_numpy(mask).to(x.device) if mask is not None else None
    if fused and fused_ok(window, c // heads, heads):
        windows = _window_partition_wm(h, window)
        attn = _cosine_window_attention_fused(bp, windows, heads, bias, mask,
                                              dtype, fused_train)
        h = _window_reverse_wm(attn, window, res, res)
    else:
        windows = _window_partition(h, window)
        attn = _cosine_window_attention(bp, windows, heads, bias, mask, dtype)
        h = _window_reverse(attn, window, res, res)
    if shift > 0:
        h = torch.roll(h, (shift, shift), dims=(1, 2))
    h = h.reshape(b, res * res, c)
    if fused_ln:
        x = fused_layernorm(bp["ln1"], h, eps, shortcut=shortcut)
    else:
        x = shortcut + L.layernorm(bp["ln1"], h, eps)
    ffn = L.linear(bp["ffn_in"], x, dtype)
    ffn = F.gelu(ffn, approximate="none")
    ffn = L.linear(bp["ffn_out"], ffn, dtype)
    if fused_ln:
        return fused_layernorm(bp["ln2"], ffn, eps, shortcut=x)
    return x + L.layernorm(bp["ln2"], ffn, eps)


def _patch_merge(dp: L.ParamTree, x: torch.Tensor, res: int, eps: float,
                 dtype, fused_ln: bool) -> torch.Tensor:
    """(B, res*res, C) -> (B, (res/2)^2, 2C). Concat order [x0;x1;x2;x3] =
    strides [(0,0),(1,0),(0,1),(1,1)], reduce, THEN norm (v2)."""
    b, _, c = x.shape
    g = x.reshape(b, res, res, c)
    parts = [g[:, 0::2, 0::2], g[:, 1::2, 0::2],
             g[:, 0::2, 1::2], g[:, 1::2, 1::2]]
    h = torch.cat(parts, dim=-1).reshape(b, (res // 2) ** 2, 4 * c)
    h = L.linear(dp["reduction"], h, dtype)
    if fused_ln:
        return fused_layernorm(dp["norm"], h, eps)
    return L.layernorm(dp["norm"], h, eps)


def swin_forward(params: L.ParamTree, cfg: SwinConfig, images: torch.Tensor
                 ) -> torch.Tensor:
    """(B, H, W, 3) float NHWC -> last_hidden_state (B, num_tokens, hidden),
    HF Swinv2Model's (final LayerNorm applied, no pooler)."""
    dtype = L.dtype_of(cfg.compute_dtype)
    eps = cfg.layer_norm_eps
    # remat (a training option) keeps the plain LayerNorm, as in the JAX
    # package
    fln = cfg.fused_ln and not cfg.remat
    remat = cfg.remat and torch.is_grad_enabled()
    x = patchify(images.to(dtype), cfg.patch_size)
    x = L.linear(params["patch_embed"], x, dtype)
    x = (fused_layernorm(params["embed_ln"], x, eps) if fln
         else L.layernorm(params["embed_ln"], x, eps))
    for s in range(cfg.num_stages):
        res = cfg.stage_res(s)
        stage = params["stages"][s]
        for i, bp in enumerate(stage["blocks"]):
            window, shift = cfg.stage_window_shift(s, i)
            args = (bp, x, res, cfg.num_heads[s], window, shift,
                    cfg.pretrained_window_sizes[s], eps, dtype,
                    cfg.fused_attn, fln, cfg.fused_train)
            x = (checkpoint(_block, *args, use_reentrant=False) if remat
                 else _block(*args))
        if "downsample" in stage:
            x = _patch_merge(stage["downsample"], x, res, eps, dtype, fln)
    return (fused_layernorm(params["ln_final"], x, eps) if fln
            else L.layernorm(params["ln_final"], x, eps))
