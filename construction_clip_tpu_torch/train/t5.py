"""ClipCap mT5 caption training step (counterpart of construction_clip_tpu/train/
t5.py:make_t5_caption_train_step): the CE of the prefix-aligned caption slice,
AdamW.

Two modes, as the JAX step. With `ccfg.only_prefix` the state's params are the
mapper alone and T5 comes in as a frozen tree (no leaf requires grad; cast it
to the compute dtype once, before the first step), so the optimizer state
covers the mapper alone. Otherwise the state's params are the whole
{"mapper", "t5"} tree.

The step casts the trainable tree to the compute dtype once, at its top, under
autograd: t5_encode and t5_decode each cast the whole T5 tree they are given,
and on a tree already in the compute dtype those casts return their input, so
each leaf (mT5's 128M-row `shared` and `lm_head` included) is cast once a step
and its gradient comes back through one cast.

Data-parallel (`dp`, core/mesh.py, with more than one rank), as the JAX step
under shard_map over the "data" axis: each rank's loss is its own rows' NLL
sum over the GLOBAL count of valid tokens (all_reduced outside autograd), and
the gradients and the loss are SUMMED over the ranks (JAX's psum), so that
any mix of padding over the ranks gives the one-process step
(train/grads.token_mean_grads). Every rank then applies the same in-place AdamW (train/state.py).

No hand kernel runs here, as no Pallas kernel runs in the JAX step: T5's
training attention is plain math on both sides (models/t5.py), and its LM
head is a matmul (K8 serves cached decode steps only).
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, T5Config
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clipcap.t5_model import (
    clipcap_t5_forward, t5_caption_loss_parts)
from construction_clip_tpu_torch.train.grads import token_mean_grads
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients

BATCH_KEYS = ("input_ids", "attention_mask", "prefix")


def loss_and_grads(trainable, frozen_t5, ccfg: ClipCapConfig, tcfg: T5Config, batch, *,
                   policy: Policy = DEFAULT_POLICY, dp=None):
    """-> (loss, grads): the token-mean caption CE of `batch` and its gradient
    as a tree of `trainable`'s layout (the mapper with `ccfg.only_prefix`,
    else {"mapper", "t5"}). With `dp`, the batch is this rank's rows and the
    loss and gradients those of the global batch, the same on every rank."""
    trainable = as_tree(trainable)
    cast = policy.cast_to_compute(trainable)   # once a step; the model's casts are no-ops
    params = {"mapper": cast, "t5": frozen_t5} if ccfg.only_prefix else cast
    logits = clipcap_t5_forward(params, ccfg, tcfg, input_ids=batch["input_ids"],
                                attention_mask=batch["attention_mask"],
                                clip_embed=batch["prefix"], policy=policy)
    total, count = t5_caption_loss_parts(logits, batch["input_ids"], ccfg)
    del logits, cast, params
    return token_mean_grads(total, count, trainable, dp)


def make_t5_caption_train_step(ccfg: ClipCapConfig, tcfg: T5Config, tx, *,
                               policy: Policy = DEFAULT_POLICY, device=None, dp=None):
    """Returns (state, frozen_t5, batch) -> (state, metrics).

    `frozen_t5`: T5's tree with `ccfg.only_prefix` (cast it to the policy's
    compute dtype once, before the first step: the step casts nothing that is
    already in that dtype), else None. `batch`: {"input_ids": [B,T] int,
    "attention_mask": [B,T] int, "prefix": [B,clip_dim] float}, moved to
    `device` (the params' device when None); with `dp`, this rank's rows of
    the global batch. The params and moments are updated in place; the loss
    metric is a tensor on the device."""

    def step(state: TrainState, frozen_t5, batch):
        params = as_tree(state.params)
        dev = device or tree_leaves(params)[0].device
        on = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in BATCH_KEYS}
        frozen = policy.cast_to_compute(as_tree(frozen_t5)) if ccfg.only_prefix else None
        loss, grads = loss_and_grads(params, frozen, ccfg, tcfg, on, policy=policy, dp=dp)
        return apply_gradients(state, grads, tx), {"loss": loss}

    return step
