"""int8 weight quantization (counterpart of construction_clip_tpu/ops/quant.py:
quantize_weight): symmetric, one fp32 scale per output column,
scale = max|w| / 127 over the contracting axis (1 where a column is all zero)."""

from __future__ import annotations

import torch


def quantize_weight(w, *, axis: int = 0):
    """w [in, out] (y = x @ W) -> (int8 w, fp32 scale [out]); `axis` is the
    contracting axis, the scales live on the remaining one."""
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(axis)
