"""Symmetric InfoNCE (counterpart of construction_clip_tpu/parallel/infonce.py):
`local_infonce` on one device, and `global_infonce` over the data-parallel
ranks of core/mesh.py.

`global_infonce` follows the JAX package's line for line: every rank scores
its local rows against the all-gathered global columns (a [local_B,
global_B] block, never the full matrix), with labels rank * local_B +
arange, and the loss and accuracy are averaged over the ranks. The gather is
K10 on the card (ops/collectives.all_gather); its gradient is the transpose
JAX takes, a psum_scatter: the sum over ranks of the gradient rows that
belong to this rank (all_reduce, then this rank's rows). The mean over ranks
differentiates as JAX's pmean does: all_reduce of the cotangent over the
world size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.ops.collectives import all_gather


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


class _GatherRows(torch.autograd.Function):
    """all_gather with the gradient of JAX's tiled all_gather: psum_scatter."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return all_gather(x, dp)

    @staticmethod
    def backward(ctx, g):
        dp = ctx.dp
        total = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(total, group=dp.group)
        rows = total.shape[0] // dp.world
        return total[dp.rank * rows:(dp.rank + 1) * rows], None


class _PMean(torch.autograd.Function):
    """The mean over ranks, differentiated as JAX's pmean."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return pmean(x, dp)

    @staticmethod
    def backward(ctx, g):
        return pmean(g, ctx.dp), None


def pmean(x, dp):
    """The mean of `x` over the ranks (a new tensor; no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=dp.group)
    return out / dp.world


def global_infonce(img_feats, txt_feats, logit_scale, dp):
    """Global-batch symmetric InfoNCE over the ranks of `dp`.

    img_feats / txt_feats: this rank's [local_B, E] rows, L2-normalized.
    Returns (loss, accuracy), both averaged over the ranks; the loss carries
    the gradient."""
    local_b = img_feats.shape[0]
    all_txt = _GatherRows.apply(txt_feats, dp)
    all_img = _GatherRows.apply(img_feats, dp)

    scale = torch.exp(logit_scale)
    logits_i = scale * img_feats @ all_txt.T
    logits_t = scale * txt_feats @ all_img.T
    labels = dp.rank * local_b + torch.arange(local_b, device=img_feats.device)

    loss = 0.5 * (_cross_entropy(logits_i, labels) + _cross_entropy(logits_t, labels))
    loss = _PMean.apply(loss, dp)
    acc = (logits_i.argmax(dim=-1) == labels).float().mean()
    return loss, pmean(acc, dp)
