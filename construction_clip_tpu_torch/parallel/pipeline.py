"""Pipeline parallelism: the GPipe microbatch schedule over the mesh's
"pipe" line (counterpart of construction_clip_tpu/parallel/pipeline.py).

  * The line holds S stages; stage s owns layers [s L/S, (s+1) L/S) of
    GPT-2's stacked blocks (`shard_stages`). No parameter moves; only [mb,
    T, D] activations cross stages, by point-to-point sends.
  * The batch (this rank's rows) is split into M microbatches. The
    schedule runs M + S - 1 ticks: at tick t stage s transforms microbatch
    t - s, stage 0 from the feed and every other stage what its
    predecessor sent; a stage idles where t - s is no microbatch (the
    bubble, (S - 1) / (M + S - 1) of the ticks). JAX's scan computes
    garbage in those ticks and masks it; the port's eager loop skips them.
  * Backward is autograd THROUGH the pipelined forward, as JAX's is
    jax.grad through its scan: `_Send` and `_Recv` are autograd Functions
    whose backwards run the schedule in reverse (a send's backward receives
    its output's cotangent from the next stage, a receive's backward sends
    the cotangent of what it received back), with the full activation
    stash of every microbatch held until then. `remat=True` checkpoints
    each layer, as gpt2_forward(remat=) does, to trade recompute for stash.
  * The last stage's outputs are broadcast to every stage (`_FromLast`, JAX's
    masked psum), so that what follows (the head, the loss) runs on every
    stage. Its cotangent enters the reverse schedule once, from the last
    stage: the other stages' copies of it are the same and are dropped.
  * Only stage 0 reads the pipeline's input, but every stage's mapper and
    embeddings made it: its cotangent is summed over the line (`_PipeInput`,
    JAX's transpose of a replicated input), so that every stage holds
    stage 0's gradient for them, and the tied wte (the embedding on stage 0,
    the head on every stage) the sum of both on every stage.
Each stage applies GPT-2's own layer (models/gpt2._uncached_layer): cuBLAS
and plain torch, no hand kernel, as no Pallas call runs in JAX's stages.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from construction_clip_tpu_torch.core.params import ParamTree, as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.parallel import comm

PIPE_AXIS = "pipe"


class _PipeInput(torch.autograd.Function):
    """Identity forward; the cotangent summed over the pipe line."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.pipe = pipe
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.pipe.group)
        return total.to(g.dtype), None


class _Recv(torch.autograd.Function):
    """The previous stage's output for microbatch `tag` (`like` gives its
    shape and type; `like`'s own values are not read). Backward: sends the
    cotangent back, and gives `like` a zero gradient."""

    @staticmethod
    def forward(ctx, like, pipe, tag):
        ctx.pipe, ctx.tag = pipe, tag
        return comm.recv(like.shape, like.dtype, like.device, pipe.rank - 1, pipe, tag)

    @staticmethod
    def backward(ctx, g):
        comm.send(g, ctx.pipe.rank - 1, ctx.pipe, ctx.tag)
        return torch.zeros_like(g), None, None


class _Send(torch.autograd.Function):
    """Sends this stage's output for microbatch `tag` to the next stage and
    returns an empty token, which the pipeline's output takes in. Backward:
    receives that output's cotangent from the next stage."""

    @staticmethod
    def forward(ctx, out, pipe, tag):
        ctx.pipe, ctx.tag = pipe, tag
        ctx.meta = (out.shape, out.dtype, out.device)
        comm.send(out, pipe.rank + 1, pipe, tag)
        return out.new_empty(0)

    @staticmethod
    def backward(ctx, _token_grad):
        shape, dtype, device = ctx.meta
        return comm.recv(shape, dtype, device, ctx.pipe.rank + 1, ctx.pipe, ctx.tag), None, None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs, concatenated, on every stage: `parts` are
    the microbatches' outputs on the last stage and the sends' tokens
    elsewhere. Backward: the cotangent goes to the last stage's outputs,
    once; a token's is empty."""

    @staticmethod
    def forward(ctx, pipe, shape, dtype, *parts):
        ctx.pipe, ctx.n = pipe, len(parts)
        last = pipe.rank == pipe.world - 1
        out = torch.cat(parts) if last else torch.empty(shape, dtype=dtype,
                                                        device=parts[0].device)
        ctx.rows = [p.shape[0] for p in parts] if last else None
        dist.broadcast(out, comm.global_rank(pipe, pipe.world - 1), group=pipe.group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.rows is not None:
            return (None, None, None) + tuple(g.split(ctx.rows))
        return (None, None, None) + tuple(g.new_empty(0) for _ in range(ctx.n))


def pipeline_apply(stage_fn, stage_params, x_micro: list, pipe):
    """The GPipe schedule over the `pipe` line (its DataParallel view).

    stage_fn(stage_params, h) -> h applies this stage's layers to one
    microbatch [mb, ...] (shape-preserving); x_micro: the M microbatches,
    the same on every stage (only stage 0 reads their values). Returns the
    last stage's outputs concatenated [M mb, ...], on every stage."""
    S, s, M = pipe.world, pipe.rank, len(x_micro)
    outputs, tokens = [], []
    for t in range(M + S - 1):
        m = t - s
        if not 0 <= m < M:
            continue   # this stage's bubble tick
        inp = x_micro[m] if s == 0 else _Recv.apply(x_micro[m], pipe, m)
        out = stage_fn(stage_params, inp)
        if s == S - 1:
            outputs.append(out)
        else:
            tokens.append(_Send.apply(out, pipe, m))
    if S == 1:
        return torch.cat(outputs)
    shape = (sum(x.shape[0] for x in x_micro),) + tuple(x_micro[0].shape[1:])
    return _FromLast.apply(pipe, shape, x_micro[0].dtype, *(outputs or tokens))


def pipelined_blocks(blocks, x, attn_bias, cfg, mesh, *, microbatches: int,
                     axis: str = PIPE_AXIS, remat: bool = False, dp_axis: str | None = None):
    """GPT-2's block stack applied to x [b, T, D] through the pipeline over
    the mesh's `axis` line. `blocks` is this stage's slice of the stacked
    tree [L/S, ...] (shard_stages); x is this rank's rows, the same on every
    stage, split into `microbatches`. Returns [b, T, D] on every stage.
    dp_axis: the data axis whose line holds the other rows (JAX shards x
    over it; here each rank holds its rows already, so it is only checked to
    be the mesh's). remat: each layer checkpointed, its input alone kept."""
    from construction_clip_tpu_torch.models.gpt2 import _uncached_layer

    pipe = mesh.axis(axis)
    if dp_axis is not None:
        mesh.axis(dp_axis)
    b = x.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} microbatches")
    # one unbind per leaf: its backward stacks the layers' gradients in one op
    views = tree_map(lambda z: z.unbind(0), blocks)
    layers = [tree_map(lambda v: v[i], views) for i in range(blocks["ln_1"]["scale"].shape[0])]

    def stage(stage_layers, h):
        for lp in stage_layers:
            layer = functools.partial(_uncached_layer, lp, cfg=cfg, attn_bias=attn_bias)
            h = (checkpoint(layer, h, use_reentrant=False, preserve_rng_state=False)
                 if remat else layer(h))[0]
        return h

    if pipe.world > 1 and torch.is_grad_enabled() and not x.requires_grad and \
            any(leaf.requires_grad for leaf in tree_leaves(blocks)):
        # a stage's sends would wait for cotangents that no receive sends back
        raise ValueError("the pipeline's backward runs through its input: x must require "
                         "grad where the blocks do (the mapper's and embeddings' path)")
    if pipe.world > 1:
        x = _PipeInput.apply(x, pipe)
    return pipeline_apply(stage, layers, list(x.chunk(microbatches)), pipe)


def shard_stages(mesh, params, *, axis: str = PIPE_AXIS, key: str = "blocks"):
    """This stage's tree: every leaf under a `key` subtree (a layer stack)
    sliced to the stage's layers [s L/S, (s+1) L/S), the rest copied (a
    ParamTree comes back as one, as trainable as it was). A ValueError where
    the line's size does not divide the layers."""
    pipe = mesh.axis(axis)

    def walk(node, inside):
        if isinstance(node, dict):
            return {k: walk(v, inside or k == key) for k, v in node.items()}
        if not inside:
            return node.detach().clone()
        n_layer = node.shape[0]
        if n_layer % pipe.world:
            raise ValueError(f"{n_layer} layers not divisible by {axis}={pipe.world}")
        n = n_layer // pipe.world
        return node.detach()[pipe.rank * n:(pipe.rank + 1) * n].clone()

    out = walk(as_tree(params), False)
    if isinstance(params, ParamTree):
        return ParamTree(out, trainable=any(p.requires_grad for p in params.parameters()))
    return out


def stage_leaves(params, key: str = "blocks") -> dict:
    """A tree of bools of the params' layout: True under a `key` subtree
    (the leaves split over the pipe line)."""
    def walk(node, inside):
        if isinstance(node, dict):
            return {k: walk(v, inside or k == key) for k, v in node.items()}
        return inside

    return walk(as_tree(params), False)
