"""LayerNorm and T5's RMSNorm with fp32 statistics whatever the input dtype
(counterpart of construction_clip_tpu/ops/norms.py): bf16 inputs are upcast
for the moments and the result is cast back."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, *, eps: float = 1e-5):
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dtype)


def rms_norm(x, scale, *, eps: float = 1e-6):
    """T5 RMSNorm in HF's order: variance in fp32, normalise, cast to x's dtype,
    then scale (no mean, no bias)."""
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(dtype)
    return (y * scale).to(dtype)
