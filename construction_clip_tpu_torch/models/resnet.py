"""ResNet-50, the port of construction_clip_tpu/models/resnet.py: 7x7/2 stem,
max-pool, bottleneck stages [3, 4, 6, 3], BatchNorm in inference form
(running statistics folded into scale/shift when weights are converted; the
detector's training trains the scale and shift, train/detection.py).
`resnet50_features` is the show-attend-tell captioner's frozen encoder.

Activations are logical NCHW tensors in `torch.channels_last` memory (NHWC
bytes, the layout cuDNN runs its NHWC kernels on); convolution weights are
OIHW, permuted once from the JAX tree's HWIO when the weights are carried
across (`convert.to_detector_params`, which takes any tree of this layout).
`from_torchvision_state_dict` gives the JAX package's tree (HWIO), array for
array.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

STAGES = (3, 4, 6, 3)
WIDTHS = (64, 128, 256, 512)


def _conv(x, w, stride: int = 1):
    """w: OIHW. Symmetric padding of k // 2 a side, torch Conv2d(padding=k//2)
    (the JAX package pads explicitly for the same numerics)."""
    return F.conv2d(x, w, stride=stride, padding=(w.shape[2] // 2, w.shape[3] // 2))


def _bn(x, p):
    """Inference BatchNorm as a per-channel scale and shift."""
    return x * p["scale"][:, None, None] + p["shift"][:, None, None]


def _bottleneck(x, p, stride: int):
    out = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"], stride=stride), p["bn2"]))
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = _bn(_conv(x, p["downsample"]["conv"], stride=stride), p["downsample"]["bn"])
    return torch.relu(out + x)


def stem(params, images):
    """images [B, 3, H, W] -> the max-pooled stride-4 map (the pool pads with
    -inf, as the JAX package's reduce_window does)."""
    x = torch.relu(_bn(_conv(images, params["stem"]["conv"], stride=2), params["stem"]["bn"]))
    return F.max_pool2d(x, 3, 2, padding=1)


def resnet50_features(params, images):
    """images [B, H, W, 3] (normalized floats) -> [B, (H/32)*(W/32), 2048],
    the grid's rows in the JAX package's order (row-major over H, W)."""
    x = stem(params, images.permute(0, 3, 1, 2))   # NCHW over NHWC bytes: channels-last
    for s, blocks in enumerate(params["stages"]):
        for b, bp in enumerate(blocks):
            x = _bottleneck(x, bp, 2 if (s > 0 and b == 0) else 1)
    b, c = x.shape[:2]
    return x.permute(0, 2, 3, 1).reshape(b, -1, c)


def from_torchvision_state_dict(sd, *, eps: float = 1e-5) -> dict:
    """torchvision resnet50 state dict -> the JAX package's tree (numpy, HWIO
    convolutions, BatchNorm folded to scale/shift)."""
    def a(k):
        x = sd[k]
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        return np.asarray(x)

    def conv(k):
        return a(k).transpose(2, 3, 1, 0)  # OIHW -> HWIO

    def bn(prefix):
        gamma, beta = a(f"{prefix}.weight"), a(f"{prefix}.bias")
        mean, var = a(f"{prefix}.running_mean"), a(f"{prefix}.running_var")
        scale = gamma / np.sqrt(var + eps)
        return {"scale": scale, "shift": beta - mean * scale}

    stages = []
    for s in range(4):
        blocks = []
        for b in range(STAGES[s]):
            pre = f"layer{s + 1}.{b}"
            p = {
                "conv1": conv(f"{pre}.conv1.weight"), "bn1": bn(f"{pre}.bn1"),
                "conv2": conv(f"{pre}.conv2.weight"), "bn2": bn(f"{pre}.bn2"),
                "conv3": conv(f"{pre}.conv3.weight"), "bn3": bn(f"{pre}.bn3"),
            }
            if f"{pre}.downsample.0.weight" in sd:
                p["downsample"] = {"conv": conv(f"{pre}.downsample.0.weight"),
                                   "bn": bn(f"{pre}.downsample.1")}
            blocks.append(p)
        stages.append(blocks)
    return {"stem": {"conv": conv("conv1.weight"), "bn": bn("bn1")}, "stages": stages}
