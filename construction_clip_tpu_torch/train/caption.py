"""ClipCap caption-LM training step (counterpart of construction_clip_tpu/train/
caption.py:make_caption_train_step): the CE of the caption slice, AdamW.

Two modes, as the JAX step. With `ccfg.only_prefix` the state's params are the
mapper alone and GPT-2 comes in as a frozen tree (no leaf requires grad; the
activations still carry the gradient back to the mapper), so the optimizer
state covers the mapper alone. Otherwise the state's params are the whole
{"mapper", "gpt"} tree.

Data-parallel (`dp`, core/mesh.py, with more than one rank), as the JAX step
under shard_map over the "data" axis: each rank's loss is its own rows' NLL
sum over the GLOBAL count of valid tokens (all_reduced outside autograd), and
the gradients and the loss are SUMMED over the ranks (JAX's psum), so that
any mix of padding over the ranks gives the one-process step. Every rank
then applies the same in-place AdamW (train/state.py).

Pipeline-parallel (`make_caption_train_step_pp`, the full fine-tune over a
mesh with a "pipe" axis and, optionally, "data"): GPT-2's block stack is
split into stages (`shard_clipcap_params_pp`) and driven by the GPipe
schedule (parallel/pipeline.py); the mapper, embeddings, head and loss run
on every stage, the loss is the global token mean over the data line, as
above, and a gradient clip in `tx` takes the norm of the whole tree (the
stages' squares summed over the pipe line, each replicated leaf once).

No hand kernel runs here, as no Pallas kernel runs in the JAX step: GPT-2's
training attention is plain math on both sides (models/gpt2.py).
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.mesh import DATA_AXIS
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clipcap.model import (
    caption_loss_parts, clipcap_forward, clipcap_forward_pp)
from construction_clip_tpu_torch.parallel.pipeline import PIPE_AXIS, shard_stages, stage_leaves
from construction_clip_tpu_torch.parallel.sharding import sharded_global_norm
from construction_clip_tpu_torch.train.grads import token_mean_grads
from construction_clip_tpu_torch.train.state import (
    TrainState, apply_gradients, global_norm_rule)

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


def shard_clipcap_params_pp(mesh, params):
    """This stage's full ClipCap tree for pipeline parallelism: GPT-2's
    block stack cut to the stage's layers [s L/S, (s+1) L/S) on the mesh's
    "pipe" line, the mapper, embeddings and ln_f whole. A ValueError where S
    does not divide the layers."""
    return shard_stages(mesh, params, axis=PIPE_AXIS)


def make_caption_train_step_pp(ccfg: ClipCapConfig, gcfg: GPT2Config, tx, mesh, *,
                               microbatches: int, policy: Policy = DEFAULT_POLICY,
                               remat=False, device=None):
    """The pipeline-parallel full fine-tune step over `mesh`: returns (state,
    batch) -> (state, metrics). state.params is this stage's
    {"mapper", "gpt"} tree (shard_clipcap_params_pp, before
    TrainState.create, so that AdamW's moments take the stage's layout);
    `batch` is this rank's rows (core/mesh.shard_batch over the "data" line,
    or the whole batch without one), split into `microbatches`. The loss is
    the global batch's token mean, the same on every rank; equal to the
    one-device make_caption_train_step on the same params and batch."""
    pipe = mesh.axis(PIPE_AXIS)
    data = mesh.lines.get(DATA_AXIS)
    dp_axis = DATA_AXIS if mesh.size(DATA_AXIS) > 1 else None

    def step(state: TrainState, batch):
        params = as_tree(state.params)
        dev = device or tree_leaves(params)[0].device
        on = {k: torch.as_tensor(batch[k]).to(dev, non_blocking=True) for k in BATCH_KEYS}
        logits = clipcap_forward_pp(params, ccfg, gcfg, tokens=on["tokens"],
                                    clip_embed=on["prefix"], attribute_tokens=on["attribute"],
                                    mesh=mesh, microbatches=microbatches, policy=policy,
                                    remat=remat, dp_axis=dp_axis)
        total, count = caption_loss_parts(logits, on["tokens"], ccfg)
        del logits
        loss, grads = token_mean_grads(total, count, params, data)
        marks = stage_leaves(params)
        with global_norm_rule(lambda g: sharded_global_norm(g, marks, pipe)):
            new_state = apply_gradients(state, grads, tx)
        return new_state, {"loss": loss}

    return step
