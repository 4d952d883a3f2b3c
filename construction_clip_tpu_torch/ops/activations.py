"""The activation variants the backbones use (counterpart of
construction_clip_tpu/ops/activations.py).

- quick_gelu: x * sigmoid(1.702 x), OpenAI CLIP's activation.
- gelu_new:   tanh-approximated GELU, GPT-2's activation (HF "gelu_new").
- gelu_gated: the GELU-gated feedforward halves, mT5's activation.
"""

from __future__ import annotations

import torch


def quick_gelu(x):
    return x * torch.reciprocal(1.0 + torch.exp(-1.702 * x))


def gelu_new(x):
    c = 0.7978845608028654  # sqrt(2/pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def gelu_gated(gate, up):
    return gelu_new(gate) * up
