"""Fused image normalize, uint8 RGB -> ((x / 255) - mean) / std in one pass
(counterpart of construction_clip_tpu/ops/pallas_preprocess.py).

`normalize_u8` launches csrc/normalize_u8.cu (K6) on CUDA tensors and runs
`normalize_u8_plain` on CPU tensors. Both keep the Pallas kernel's rounding
points: the byte as fp32 times the fp32 constant 1/255 (a multiply by the
reciprocal, not a division), minus the fp32 mean, times inv_std = f32(1) /
f32(std), then one cast to `out_dtype`; on the card the two are bit-equal.

Its only caller in either package is data/preprocess.py:preprocess_staged
(images already at model resolution); the serving path normalizes inside
preprocess_batch. The Pallas kernel's int32 widening of the bytes is a Mosaic
workaround and is not carried over.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.ops import _build

INV_255 = float(np.float32(1.0 / 255.0))   # the Pallas kernel's fp32 constant


def _constants(mean, std) -> tuple[np.ndarray, np.ndarray]:
    """fp32 mean and fp32 1/std per channel."""
    mean32 = np.asarray(mean, np.float32)
    inv_std = np.float32(1.0) / np.asarray(std, np.float32)
    if mean32.shape != (3,) or inv_std.shape != (3,):
        raise ValueError(f"normalize_u8 takes 3 channel means and stds, got {mean}, {std}")
    return mean32, inv_std


@functools.lru_cache(maxsize=16)
def _kernel_constants(mean: tuple, std: tuple) -> tuple[float, ...]:
    """`_constants` as the kernel's six float arguments (fp32 values), kept
    per (mean, std): the wrapper computes them once, not on every call."""
    mean32, inv_std = _constants(mean, std)
    return tuple(float(v) for v in (*mean32, *inv_std))


def _check(images_u8, out_dtype) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4 or images_u8.shape[-1] != 3:
        raise ValueError(f"normalize_u8 takes uint8 [B, H, W, 3], got {images_u8.dtype} "
                         f"{tuple(images_u8.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"normalize_u8 writes float32 or bfloat16, not {out_dtype}")


def normalize_u8_plain(images_u8, *, mean, std, out_dtype=torch.float32):
    _check(images_u8, out_dtype)
    mean32, inv_std = _constants(mean, std)
    x = images_u8.float() * INV_255
    dev = images_u8.device
    return ((x - torch.from_numpy(mean32).to(dev)) * torch.from_numpy(inv_std).to(dev)).to(
        out_dtype)


def normalize_u8(images_u8, *, mean, std, out_dtype=torch.float32):
    """[B, H, W, 3] uint8 -> [B, H, W, 3] out_dtype, ((x / 255) - mean) / std."""
    if _build.on_cpu(images_u8, "normalize_u8"):
        return normalize_u8_plain(images_u8, mean=mean, std=std, out_dtype=out_dtype)
    _check(images_u8, out_dtype)
    constants = _kernel_constants(tuple(mean), tuple(std))
    x = images_u8.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.load_library().cct_normalize_u8(
            _build.dtype_code(out_dtype), x.data_ptr(), out.data_ptr(), x.numel(), INV_255,
            *constants, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "normalize_u8")
    tracing.count("k6")
    return out
