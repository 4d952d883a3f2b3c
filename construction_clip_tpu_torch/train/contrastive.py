"""Contrastive fine-tune step on one device (counterpart of the single-device
branch of construction_clip_tpu/train/contrastive.py: encode both towers,
symmetric InfoNCE over the batch, AdamW). The multi-device step (global-batch
InfoNCE) is not ported yet.

On the card every tower block runs through the port's kernels, forward and
backward: the fused block (K1, K3) at T <= 256, flash attention (K4, K5) above.
"""

from __future__ import annotations

import torch

from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text
from construction_clip_tpu_torch.parallel.infonce import local_infonce
from construction_clip_tpu_torch.train.state import TrainState, apply_gradients


def _loss_and_accuracy(params, cfg, images, tokens, policy):
    img_f = encode_image(params, cfg, images, policy=policy, normalize=True)
    txt_f = encode_text(params, cfg, tokens, policy=policy, normalize=True)
    loss, logits = local_infonce(img_f, txt_f, params["logit_scale"])
    labels = torch.arange(logits.shape[0], device=logits.device)
    return loss, (logits.argmax(dim=-1) == labels).float().mean()


def loss_and_grads(params, cfg: CLIPConfig, images, tokens, *,
                   policy: Policy = DEFAULT_POLICY):
    """-> (loss, accuracy, grads): the gradient of the symmetric InfoNCE loss
    as a tree of the params' layout."""
    params = as_tree(params)
    loss, acc = _loss_and_accuracy(params, cfg, images, tokens, policy)
    it = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return loss.detach(), acc, tree_map(lambda _: next(it), params)


def _on(batch, device):
    return (batch["images"].to(device, non_blocking=True),
            batch["tokens"].to(device, non_blocking=True))


def make_train_step(cfg: CLIPConfig, tx, *, policy: Policy = DEFAULT_POLICY, device=None):
    """Returns (state, batch) -> (state, metrics).

    batch: {"images": [B,H,W,3] float, preprocessed; "tokens": [B,ctx] int},
    moved to `device` (the params' device when None). The state's params and
    optimizer moments are updated in place (train/state.py). Metrics are
    tensors on the device, so a step does not wait for the card."""

    def step(state: TrainState, batch):
        params = as_tree(state.params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        loss, acc, grads = loss_and_grads(params, cfg, images, tokens, policy=policy)
        new_state = apply_gradients(state, grads, tx)
        return new_state, {"loss": loss, "accuracy": acc,
                           "logit_scale": params["logit_scale"].detach()}

    return step


def make_eval_step(cfg: CLIPConfig, *, policy: Policy = DEFAULT_POLICY, device=None):
    """Batch accuracy of image->text retrieval within the batch."""

    @torch.inference_mode()
    def eval_step(params, batch):
        params = as_tree(params)
        images, tokens = _on(batch, device or tree_leaves(params)[0].device)
        return _loss_and_accuracy(params, cfg, images, tokens, policy)[1]

    return eval_step
