"""Contrastive fine-tune step (counterpart of construction_clip_tpu/train/contrastive.py:
make_train_step and make_eval_step): encode both towers, symmetric InfoNCE,
AdamW.

On one device the loss is `local_infonce` over the batch. Data-parallel
(`dp`, core/mesh.py, with more than one rank), as the JAX step under
shard_map over the "data" axis: each rank encodes its own rows, the loss is
`global_infonce` (the features all-gathered by K10 on the card), the
gradients are averaged over the ranks (JAX's pmean: all_reduce over
`dp.group`, divided by the world size), and every rank applies the same
in-place AdamW to its replica of the params (train/state.py). The step uses
the process group it is given and chooses no backend.

On the card every tower block runs through the port's kernels, forward and
backward: the fused block (K1, K3) at T <= 256, flash attention (K4, K5) above.

`make_gspmd_train_step` is the tensor x data parallel step (the JAX
package's GSPMD step, BASELINE config 5's ViT-L/14): the params are this
rank's shard over the mesh's "model" line (parallel/sharding.py), both
towers run the blocks' tensor-parallel route (every attention K4 / K5 over
the rank's heads on the card; on a model line of one rank, the one-device
route), the loss is `global_infonce` over the "data"
line (K10 within that line), and the gradients are averaged over the data
line alone: a replicated leaf's gradient is the same on every rank of the
model line already, and each shard's belongs to its rank. A gradient clip
in `tx` takes the norm of the whole tree (the shards' squares summed over
the model line, each replicated leaf once).
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.mesh import DATA_AXIS, MODEL_AXIS
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text
from construction_clip_tpu_torch.ops.collectives import all_gather
from construction_clip_tpu_torch.parallel.infonce import global_infonce, local_infonce
from construction_clip_tpu_torch.parallel.sharding import sharded_global_norm, sharded_leaves
from construction_clip_tpu_torch.train.grads import is_parallel, mean_grads
from construction_clip_tpu_torch.train.state import (
    TrainState, apply_gradients, global_norm_rule)


def _accuracy(logits):
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (logits.argmax(dim=-1) == labels).float().mean()


def _loss_and_accuracy(params, cfg, images, tokens, policy, dp=None, remat=False, tp=None):
    img_f = encode_image(params, cfg, images, policy=policy, normalize=True, remat=remat, tp=tp)
    txt_f = encode_text(params, cfg, tokens, policy=policy, normalize=True, tp=tp)
    if is_parallel(dp):
        return global_infonce(img_f, txt_f, params["logit_scale"], dp)
    loss, logits = local_infonce(img_f, txt_f, params["logit_scale"])
    return loss, _accuracy(logits)


def loss_and_grads(params, cfg: CLIPConfig, images, tokens, *,
                   policy: Policy = DEFAULT_POLICY, dp=None, remat=False, tp=None):
    """-> (loss, accuracy, grads): the gradient of the symmetric InfoNCE loss
    as a tree of the params' layout. With `dp`, images and tokens are this
    rank's rows, and the loss, accuracy and gradients those of the global
    batch, the same on every rank. remat: the image tower's
    (models/blocks.apply_stack). tp: the "model" line whose shard `params`
    is; the gradients are then this rank's shard of the tree's."""
    params = as_tree(params)
    with tracing.span("forward"):
        loss, acc = _loss_and_accuracy(params, cfg, images, tokens, policy, dp, remat, tp)
    with tracing.span("backward"):
        loss, grads = mean_grads(loss, params, dp)
    return loss, acc, grads


def _on(batch, device):
    return (batch["images"].to(device, non_blocking=True),
            batch["tokens"].to(device, non_blocking=True))


def make_train_step(cfg: CLIPConfig, tx, *, policy: Policy = DEFAULT_POLICY, device=None,
                    dp=None, remat=False):
    """Returns (state, batch) -> (state, metrics).

    batch: {"images": [B,H,W,3] float, preprocessed; "tokens": [B,ctx] int},
    moved to `device` (the params' device when None). With `dp`, the batch is
    this rank's rows of the global batch (core/mesh.shard_batch, or
    data/loader.TorchImageTextLoader with `dp`) and the metrics are the
    global batch's. The state's params and optimizer moments are updated in
    place (train/state.py). Metrics are tensors on the device, so a step on
    one device does not wait for the card. remat: the image tower's
    rematerialisation (models/blocks.apply_stack), as in the JAX step."""

    def step(state: TrainState, batch):
        params = as_tree(state.params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        loss, acc, grads = loss_and_grads(params, cfg, images, tokens, policy=policy, dp=dp,
                                          remat=remat)
        new_state = apply_gradients(state, grads, tx)
        return new_state, {"loss": loss, "accuracy": acc,
                           "logit_scale": params["logit_scale"].detach()}

    return step


def make_gspmd_train_step(cfg: CLIPConfig, tx, mesh, *, policy: Policy = DEFAULT_POLICY,
                          remat=False, device=None):
    """The tensor x data parallel step over `mesh` (core/mesh.create_mesh with
    a "model" axis and, optionally, a "data" axis): returns (state, batch) ->
    (state, metrics), as make_train_step's. state.params is this rank's shard
    (parallel/sharding.shard_clip_params, before TrainState.create, so that
    AdamW's moments take the shard's layout); `batch` is this rank's rows of
    the global batch (core/mesh.shard_batch over mesh.axis("data")), and the
    metrics are the global batch's, the same on every rank. Equal to the
    one-device step on the same params and global batch."""
    model = mesh.axis(MODEL_AXIS)
    data = mesh.lines.get(DATA_AXIS)
    marks = sharded_leaves()

    def step(state: TrainState, batch):
        params = as_tree(state.params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        loss, acc, grads = loss_and_grads(params, cfg, images, tokens, policy=policy, dp=data,
                                          remat=remat, tp=model)
        with global_norm_rule(lambda g: sharded_global_norm(g, marks, model)):
            new_state = apply_gradients(state, grads, tx)
        return new_state, {"loss": loss, "accuracy": acc}

    return step


def make_eval_step(cfg: CLIPConfig, *, policy: Policy = DEFAULT_POLICY, device=None,
                   dp=None):
    """Batch accuracy of image->text retrieval within the batch. With `dp`,
    `batch` is this rank's rows and the accuracy that of the global batch,
    as the JAX package's jitted eval scores a batch-sharded input: both
    features are all-gathered (K10 on the card) and scored whole."""

    @torch.inference_mode()
    def eval_step(params, batch):
        params = as_tree(params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        if not is_parallel(dp):
            return _loss_and_accuracy(params, cfg, images, tokens, policy)[1]
        img_f = all_gather(encode_image(params, cfg, images, policy=policy, normalize=True), dp)
        txt_f = all_gather(encode_text(params, cfg, tokens, policy=policy, normalize=True), dp)
        return _accuracy(local_infonce(img_f, txt_f, params["logit_scale"])[1])

    return eval_step
