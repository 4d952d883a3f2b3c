"""The gradients of a train step's loss, reduced over the data-parallel ranks
(`dp`, core/mesh.DataParallel, with more than one rank) as the JAX steps
reduce them under shard_map over the "data" axis:

  mean_grads        the loss is each rank's mean over its own rows: the
                    gradients and the loss are AVERAGED (JAX's pmean; every
                    rank holds as many rows, so this is the global mean)
  token_mean_grads  the loss is a token mean: each rank's NLL sum over the
                    GLOBAL count of valid tokens, and the gradients and the
                    loss are SUMMED (JAX's psum), for any padding over the ranks

Both reduce outside the differentiated function: a reduce inside it would
multiply the gradient by the number of ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.core.params import tree_leaves, tree_map


def is_parallel(dp) -> bool:
    return dp is not None and dp.world > 1


def _reduce(loss, trainable, dp, *, mean: bool):
    grads = list(torch.autograd.grad(loss, tree_leaves(trainable)))
    loss = loss.detach()
    if is_parallel(dp):
        grads = [g.contiguous() for g in grads]
        for g in grads + [loss]:
            dist.all_reduce(g, group=dp.group)
        if mean:
            torch._foreach_div_(grads, float(dp.world))
            loss = loss / dp.world
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), trainable)


def mean_grads(loss, trainable, dp=None):
    """-> (loss, grads), grads a tree of `trainable`'s layout. With `dp`,
    `loss` is the mean over this rank's rows, and the gradients and the loss
    are averaged over the ranks."""
    return _reduce(loss, trainable, dp, mean=True)


def token_mean_grads(total, count, trainable, dp=None):
    """-> (loss, grads) of the token mean total / count, grads a tree of
    `trainable`'s layout. With `dp`, `total` is this rank's NLL sum and
    `count` its valid tokens: the count is all_reduced outside autograd, so
    each rank's loss is its share of the global token mean, and the
    gradients and the loss are summed over the ranks. Any mix of padding
    over the ranks gives the one-process step."""
    if is_parallel(dp):
        count = count.detach().clone()
        dist.all_reduce(count, group=dp.group)
    return _reduce(total / count.clamp(min=1.0), trainable, dp, mean=False)
