"""The activation variants the backbones use (counterpart of
construction_clip_tpu/ops/activations.py).

- quick_gelu: x * sigmoid(1.702 x), OpenAI CLIP's activation.
- gelu_new:   tanh-approximated GELU, GPT-2's activation (HF "gelu_new").
- gelu_gated: the GELU-gated feedforward halves, mT5's activation.

The constants are rounded to x's dtype first, as JAX's weakly typed Python
scalars are: in bf16, 1.702 is 1.703125. With that, each op rounds to bf16 as
XLA's does and a bf16 activation gives the JAX package's bits.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _const(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def quick_gelu(x):
    return x * torch.reciprocal(1.0 + torch.exp(_const(-1.702, x.dtype) * x))


def gelu_new(x):
    c = _const(0.7978845608028654, x.dtype)  # sqrt(2/pi)
    return _const(0.5, x.dtype) * x * (
        1.0 + torch.tanh(c * (x + _const(0.044715, x.dtype) * x * x * x)))


def gelu_gated(gate, up):
    return gelu_new(gate) * up
