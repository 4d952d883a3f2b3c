"""Symmetric InfoNCE on one device (counterpart of
construction_clip_tpu/parallel/infonce.py: `_cross_entropy` and `local_infonce`;
the multi-device `global_infonce` is not ported yet)."""

from __future__ import annotations

import torch


def _cross_entropy(logits, labels):
    """Mean CE over rows; logits fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


def local_infonce(img_feats, txt_feats, logit_scale):
    """Features must be L2-normalized. Returns (loss, logits_per_image)."""
    logits = torch.exp(logit_scale) * img_feats @ txt_feats.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    loss = 0.5 * (_cross_entropy(logits, labels) + _cross_entropy(logits.T, labels))
    return loss, logits
