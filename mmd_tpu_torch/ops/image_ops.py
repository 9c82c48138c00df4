"""Image preprocessing: host decode feeding device-side normalize
(counterpart of mmd_tpu/ops/image_ops.py).

The host decodes, resizes and crops (PIL, parallel threads) into uint8
NHWC; normalization runs on the device, so the host-to-device copy moves
uint8, a quarter of the fp32 bytes. The reference's train and inference
transforms disagree on mean/std (reference dataset.py:14-19 vs
evaluate.py:71-79); both are kept as named configs.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ImageTransform:
    size: int = 256
    # torchvision Normalize(mean, std) over [0,1] floats
    mean: tuple = (0.5, 0.5, 0.5)
    std: tuple = (0.229, 0.224, 0.225)
    resize_mode: str = "shorter"  # "shorter" = Resize(256)+CenterCrop; "exact" = Resize((256,256))


# Training-path transform (reference dataset.py:14-19)
TRAIN_TRANSFORM = ImageTransform()
# Inference-path transform (reference evaluate.py:71-79)
EVAL_TRANSFORM = ImageTransform(mean=(0.485, 0.456, 0.406),
                                std=(0.229, 0.224, 0.225),
                                resize_mode="exact")
# ResNet ImageNet transform @224 (reference im2im_retrieval.py:19-27)
RESNET_TRANSFORM = ImageTransform(size=224, mean=(0.485, 0.456, 0.406),
                                  std=(0.229, 0.224, 0.225),
                                  resize_mode="exact")


def load_image_uint8(path: str, t: ImageTransform) -> Optional[np.ndarray]:
    """Host: decode -> resize -> center-crop -> (size, size, 3) uint8.
    Returns None when the file cannot be read or decoded (skip-and-count
    semantics, reference dataset.py:100-110). A missing PIL is not a bad
    image: its ImportError propagates, so a host without a decoder fails
    instead of serving every request as image-less."""
    from PIL import Image
    try:
        img = Image.open(path).convert("RGB")
        if t.resize_mode == "exact":
            img = img.resize((t.size, t.size), Image.BILINEAR)
        else:
            w, h = img.size
            scale = t.size / min(w, h)
            img = img.resize((max(t.size, round(w * scale)),
                              max(t.size, round(h * scale))), Image.BILINEAR)
            w, h = img.size
            left, top = (w - t.size) // 2, (h - t.size) // 2
            img = img.crop((left, top, left + t.size, top + t.size))
        return np.asarray(img, dtype=np.uint8)
    except (OSError, ValueError):      # unreadable, truncated or not an image
        return None


def load_images_parallel(paths: Sequence[Optional[str]], t: ImageTransform,
                         workers: int = 16):
    """Host-parallel decode. Returns (batch (N,S,S,3) uint8, ok (N,) bool);
    failed/missing slots are zero-filled."""
    out = np.zeros((len(paths), t.size, t.size, 3), np.uint8)
    ok = np.zeros(len(paths), bool)

    def work(i):
        p = paths[i]
        if not p or not isinstance(p, str):
            return
        arr = load_image_uint8(p, t)
        if arr is not None:
            out[i] = arr
            ok[i] = True

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, range(len(paths))))
    return out, ok


def normalize_on_device(images_uint8: torch.Tensor, t: ImageTransform,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, S, S, 3) uint8 on the device -> normalized float NHWC."""
    x = images_uint8.float() / 255.0
    mean = torch.tensor(t.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(t.std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).to(dtype)


def bilinear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize's "bilinear" along
    one axis (antialias on, its default): half-pixel centres, the triangle
    kernel widened by 1 / scale when downsampling, each output's column of
    weights renormalised to sum to 1, and zero for a sample whose centre
    lies outside the input. Computed in float32 in JAX's order."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.0) - f32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, size, size, C) float32, the counterpart of
    `jax.image.resize(x, (N, size, size, C), "bilinear")`: one product with
    `bilinear_weights` along each spatial axis that changes size."""
    x = x.float()
    _, h, w, _ = x.shape
    if h != size:
        wh = torch.from_numpy(bilinear_weights(h, size)).to(x.device)
        x = torch.einsum("nhwc,hH->nHwc", x, wh)
    if w != size:
        ww = torch.from_numpy(bilinear_weights(w, size)).to(x.device)
        x = torch.einsum("nhwc,wW->nhWc", x, ww)
    return x


def resize_uint8(images_uint8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 NHWC -> uint8 NHWC at `size`: `resize_bilinear`, rounded half
    to even and clipped, as the JAX package resizes a bank image for the
    captioner."""
    if images_uint8.shape[1] == size and images_uint8.shape[2] == size:
        return images_uint8
    y = resize_bilinear(images_uint8, size)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
