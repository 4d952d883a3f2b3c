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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text
from construction_clip_tpu_torch.ops.collectives import all_gather
from construction_clip_tpu_torch.parallel.infonce import global_infonce, local_infonce
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients


def _parallel(dp) -> bool:
    return dp is not None and dp.world > 1


def _accuracy(logits):
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (logits.argmax(dim=-1) == labels).float().mean()


def _loss_and_accuracy(params, cfg, images, tokens, policy, dp=None):
    img_f = encode_image(params, cfg, images, policy=policy, normalize=True)
    txt_f = encode_text(params, cfg, tokens, policy=policy, normalize=True)
    if _parallel(dp):
        return global_infonce(img_f, txt_f, params["logit_scale"], dp)
    loss, logits = local_infonce(img_f, txt_f, params["logit_scale"])
    return loss, _accuracy(logits)


def loss_and_grads(params, cfg: CLIPConfig, images, tokens, *,
                   policy: Policy = DEFAULT_POLICY, dp=None):
    """-> (loss, accuracy, grads): the gradient of the symmetric InfoNCE loss
    as a tree of the params' layout. With `dp`, images and tokens are this
    rank's rows, and the loss, accuracy and gradients those of the global
    batch, the same on every rank."""
    params = as_tree(params)
    loss, acc = _loss_and_accuracy(params, cfg, images, tokens, policy, dp)
    grads = list(torch.autograd.grad(loss, tree_leaves(params)))
    if _parallel(dp):
        grads = [g.contiguous() for g in grads]
        for g in grads:
            dist.all_reduce(g, group=dp.group)
        torch._foreach_div_(grads, float(dp.world))
    it = iter(grads)
    return loss.detach(), acc, tree_map(lambda _: next(it), params)


def _on(batch, device):
    return (batch["images"].to(device, non_blocking=True),
            batch["tokens"].to(device, non_blocking=True))


def make_train_step(cfg: CLIPConfig, tx, *, policy: Policy = DEFAULT_POLICY, device=None,
                    dp=None):
    """Returns (state, batch) -> (state, metrics).

    batch: {"images": [B,H,W,3] float, preprocessed; "tokens": [B,ctx] int},
    moved to `device` (the params' device when None). With `dp`, the batch is
    this rank's rows of the global batch (core/mesh.shard_batch, or
    data/loader.TorchImageTextLoader with `dp`) and the metrics are the
    global batch's. The state's params and optimizer moments are updated in
    place (train/state.py). Metrics are tensors on the device, so a step on
    one device does not wait for the card."""

    def step(state: TrainState, batch):
        params = as_tree(state.params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        loss, acc, grads = loss_and_grads(params, cfg, images, tokens, policy=policy, dp=dp)
        new_state = apply_gradients(state, grads, tx)
        return new_state, {"loss": loss, "accuracy": acc,
                           "logit_scale": params["logit_scale"].detach()}

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
        if not _parallel(dp):
            return _loss_and_accuracy(params, cfg, images, tokens, policy)[1]
        img_f = all_gather(encode_image(params, cfg, images, policy=policy, normalize=True), dp)
        txt_f = all_gather(encode_text(params, cfg, tokens, policy=policy, normalize=True), dp)
        return _accuracy(local_infonce(img_f, txt_f, params["logit_scale"])[1])

    return eval_step
