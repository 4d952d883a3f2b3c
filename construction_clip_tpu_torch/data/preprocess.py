"""Image preprocessing, the CLIP chain (counterpart of
construction_clip_tpu/data/preprocess.py): PIL-exact bicubic resize of the
shorter side as two GEMMs with PIL's filter weights, center crop with
torchvision's rounding, scale to [0, 1], clip, per-channel normalize.

The host only decodes to uint8 RGB; the batch crosses to the device as bytes and
every float step runs there. Images already at model resolution take
`preprocess_staged`, the fused normalize alone (ops/preprocess.py, K6).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from construction_clip_tpu_torch.ops.preprocess import normalize_u8

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)   # the ResNet-50 encoder's (show-attend-tell)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize_shorter_side_shape(h: int, w: int, size: int) -> tuple[int, int]:
    """Target (H, W) for 'resize shorter side to `size`' (torchvision rounding)."""
    if h <= w:
        return size, max(size, int(round(w * size / h)))
    return max(size, int(round(h * size / w))), size


# Copied from construction_clip_tpu/data/preprocess.py:_pil_resize_weights (pure
# numpy; that module imports jax at its top, which the port must not).
@functools.lru_cache(maxsize=64)
def _pil_resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] row-stochastic weights reproducing PIL's bicubic
    resample exactly (support-scaled Keys cubic a=-0.5, per-row normalization)."""
    a = -0.5

    def cubic(x):
        x = abs(x)
        if x < 1.0:
            return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
        if x < 2.0:
            return (((x - 5.0) * x + 8.0) * x - 4.0) * a
        return 0.0

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        ks = [cubic((j + 0.5 - center) / filterscale) for j in range(lo, hi)]
        s = sum(ks)
        if s != 0:
            w[i, lo:hi] = np.asarray(ks) / s
    return w.astype(np.float32)


def resize_bicubic_pil(img, out_h: int, out_w: int):
    """PIL-parity bicubic resize of img [..., H, W, C] (float) as two dense
    weight GEMMs."""
    wh = torch.from_numpy(_pil_resize_weights(img.shape[-3], out_h)).to(img.device, img.dtype)
    ww = torch.from_numpy(_pil_resize_weights(img.shape[-2], out_w)).to(img.device, img.dtype)
    tmp = torch.einsum("oh,...hwc->...owc", wh, img)
    return torch.einsum("pw,...owc->...opc", ww, tmp)


def center_crop(img, size: int):
    # torchvision CenterCrop rounds the margin (int(round(m/2)), not m//2)
    h, w = img.shape[-3], img.shape[-2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[..., top: top + size, left: left + size, :]


def normalize(img01, mean=CLIP_MEAN, std=CLIP_STD):
    mean = torch.tensor(mean, dtype=img01.dtype, device=img01.device)
    std = torch.tensor(std, dtype=img01.dtype, device=img01.device)
    return (img01 - mean) / std


def preprocess_batch(imgs_u8, size: int = 224, *, mean=CLIP_MEAN, std=CLIP_STD,
                     device=None):
    """[B, H, W, 3] uint8 (numpy or tensor, uniform shape) -> [B, size, size, 3]
    float32 normalized, on `device` (the input's device when None)."""
    imgs = torch.as_tensor(imgs_u8)
    if device is not None:
        imgs = imgs.to(device)
    b, h, w, _ = imgs.shape
    th, tw = resize_shorter_side_shape(h, w, size)
    x = imgs.float() / 255.0
    x = resize_bicubic_pil(x, th, tw)
    x = center_crop(x, size)
    return normalize(torch.clamp(x, 0.0, 1.0), mean, std)


def preprocess_staged(images_u8, *, mean=CLIP_MEAN, std=CLIP_STD, out_dtype=None, device=None):
    """[B, S, S, 3] uint8 already at model resolution (numpy or tensor) ->
    normalized [B, S, S, 3] out_dtype (float32 when None) on `device` (the
    input's device when None), in one fused pass: K6 on the card, its plain
    version on the CPU. The JAX package's CPU path divides where K6 multiplies
    by reciprocals, so the two differ by an ulp or so."""
    imgs = torch.as_tensor(images_u8)
    if device is not None:
        imgs = imgs.to(device)
    return normalize_u8(imgs, mean=tuple(mean), std=tuple(std),
                        out_dtype=torch.float32 if out_dtype is None else out_dtype)
