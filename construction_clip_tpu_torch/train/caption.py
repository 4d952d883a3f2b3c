"""ClipCap caption-LM training step (counterpart of construction_clip_tpu/train/
caption.py:make_caption_train_step): the CE of the caption slice, AdamW.

Two modes, as the JAX step. With `ccfg.only_prefix` the state's params are the
mapper alone and GPT-2 comes in as a frozen tree (no leaf requires grad; the
activations still carry the gradient back to the mapper), so the optimizer
state covers the mapper alone. Otherwise the state's params are the whole
{"mapper", "gpt"} tree. The JAX package's pipeline-parallel step is not
ported.

Data-parallel (`dp`, core/mesh.py, with more than one rank), as the JAX step
under shard_map over the "data" axis: each rank's loss is its own rows' NLL
sum over the GLOBAL count of valid tokens (all_reduced outside autograd), and
the gradients and the loss are SUMMED over the ranks (JAX's psum), so that
any mix of padding over the ranks gives the one-process step. Every rank
then applies the same in-place AdamW (train/state.py).

No hand kernel runs here, as no Pallas kernel runs in the JAX step: GPT-2's
training attention is plain math on both sides (models/gpt2.py).
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clipcap.model import (
    caption_loss_parts, clipcap_forward)
from construction_clip_tpu_torch.train.grads import token_mean_grads
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients

BATCH_KEYS = ("tokens", "prefix", "attribute")


def loss_and_grads(trainable, frozen_gpt, ccfg: ClipCapConfig, gcfg: GPT2Config, batch, *,
                   policy: Policy = DEFAULT_POLICY, dp=None, remat=False):
    """-> (loss, grads): the token-mean caption CE of `batch` and its gradient
    as a tree of `trainable`'s layout (the mapper with `ccfg.only_prefix`,
    else {"mapper", "gpt"}). With `dp`, the batch is this rank's rows and the
    loss and gradients those of the global batch, the same on every rank."""
    trainable = as_tree(trainable)
    params = {"mapper": trainable, "gpt": frozen_gpt} if ccfg.only_prefix else trainable
    logits = clipcap_forward(params, ccfg, gcfg, tokens=batch["tokens"],
                             clip_embed=batch["prefix"], attribute_tokens=batch["attribute"],
                             policy=policy, remat=remat)
    total, count = caption_loss_parts(logits, batch["tokens"], ccfg)
    del logits
    return token_mean_grads(total, count, trainable, dp)


def make_caption_train_step(ccfg: ClipCapConfig, gcfg: GPT2Config, tx, *,
                            policy: Policy = DEFAULT_POLICY, device=None, dp=None,
                            remat=False):
    """Returns (state, frozen_gpt, batch) -> (state, metrics).

    `frozen_gpt`: GPT-2's tree with `ccfg.only_prefix` (cast it to the
    policy's compute dtype once, before the first step: the step casts
    nothing that is already in that dtype), else None. `batch`: {"tokens":
    [B,T] int, "prefix": [B,clip_dim] float, "attribute": [B,A] int}, moved to
    `device` (the params' device when None); with `dp`, this rank's rows of
    the global batch. The params and moments are updated in place; the loss
    metric is a tensor on the device. remat: GPT-2's per-layer checkpoint
    (models/gpt2.gpt2_forward), as in the JAX step."""

    def step(state: TrainState, frozen_gpt, batch):
        params = as_tree(state.params)
        dev = device or tree_leaves(params)[0].device
        on = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in BATCH_KEYS}
        frozen = policy.cast_to_compute(as_tree(frozen_gpt)) if ccfg.only_prefix else None
        loss, grads = loss_and_grads(params, frozen, ccfg, gcfg, on, policy=policy, dp=dp,
                                     remat=remat)
        return apply_gradients(state, grads, tx), {"loss": loss}

    return step
