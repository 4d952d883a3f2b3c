"""Tensor-parallel sharding of the CLIP tree (counterpart of
construction_clip_tpu/parallel/sharding.py), Megatron's column and row
split over the mesh's "model" line.

Layout (models/blocks.py, weights [in, out], stacked leading L):
  attn.w_qkv [L, D, 3D]   column-parallel, split PER HEAD: rank r holds heads
                          [r H/tp, (r+1) H/tp) of q, of k and of v, side by
                          side ([L, D, 3D/tp]), and the matching b_qkv rows
  attn.w_out [L, D, D]    row-parallel: rows of rank r's heads
  mlp.w_fc   [L, D, 4D]   column-parallel (and b_fc)
  mlp.w_proj [L, 4D, D]   row-parallel
Everything else (embeddings, LNs, b_out, b_proj, projections, the logit
scale) is replicated on every rank of the line.

The JAX package shards w_qkv's fused axis contiguously (P(None, None,
"model")) and lets GSPMD reshard around the head split; a contiguous slice
at tp=2 would give rank 0 all of q and half of k. The port's ranks compute
their heads alone, so the split is per head, and `gather_clip_params` puts
q, k and v back in place: the gather of the shards is the full tree, bit
for bit. Where tp does not divide a tower's heads or its MLP width, the
shard is refused: JAX's GSPMD can split 2 heads 4 ways, the port cannot.

`copy_to_model` and `reduce_from_model` are Megatron's two conjugate
operators (models/blocks.py's TP route puts them around each half of a
block): identity forward and all-reduce backward at a column-parallel
product's input; all-reduce forward and identity backward at a
row-parallel product's output. The all-reduce sums in fp32 and rounds once
to the activation's type, as one GEMM's fp32 accumulator would.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from construction_clip_tpu_torch.core.mesh import MODEL_AXIS
from construction_clip_tpu_torch.core.params import ParamTree, as_tree, tree_map

REPLICATED = ()
COLUMN = (None, None, MODEL_AXIS)       # [L, in, out]: out split
COLUMN_BIAS = (None, MODEL_AXIS)        # [L, out]
ROW = (None, MODEL_AXIS, None)          # [L, in, out]: in split
QKV_HEADS = "model/heads"               # the fused q|k|v axis, split per head of each
QKV = (None, None, QKV_HEADS)
QKV_BIAS = (None, QKV_HEADS)


def _block_specs() -> dict:
    return {
        "ln_1": {"scale": REPLICATED, "bias": REPLICATED},
        "attn": {"w_qkv": QKV, "b_qkv": QKV_BIAS, "w_out": ROW, "b_out": REPLICATED},
        "ln_2": {"scale": REPLICATED, "bias": REPLICATED},
        "mlp": {"w_fc": COLUMN, "b_fc": COLUMN_BIAS, "w_proj": ROW, "b_proj": REPLICATED},
    }


def clip_param_specs() -> dict:
    """The spec tree of `convert.init_clip`'s structure: each leaf a tuple
    with the split axis's name at its dimension (() replicated)."""
    ln = {"scale": REPLICATED, "bias": REPLICATED}
    return {
        "vision": {"patch_embed": REPLICATED, "class_emb": REPLICATED, "pos_emb": REPLICATED,
                   "ln_pre": dict(ln), "blocks": _block_specs(), "ln_post": dict(ln),
                   "proj": REPLICATED},
        "text": {"tok_emb": REPLICATED, "pos_emb": REPLICATED, "blocks": _block_specs(),
                 "ln_final": dict(ln), "proj": REPLICATED},
        "logit_scale": REPLICATED,
    }


def sharded_leaves() -> dict:
    """clip_param_specs as a tree of bools: True where a leaf is split."""
    return tree_map(bool, clip_param_specs())


def _split_dim(spec) -> int | None:
    for dim, name in enumerate(spec):
        if name is not None:
            return dim
    return None


def check_divisible(cfg, tree, tp: int) -> None:
    """tp must divide each tower's heads and the MLP width of its blocks."""
    for name, tower in (("vision", cfg.vision), ("text", cfg.text)):
        hidden = tree[name]["blocks"]["mlp"]["w_fc"].shape[-1]
        if tower.heads % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks does not divide the "
                             f"{name} tower's {tower.heads} heads (the port splits whole heads)")
        if hidden % tp:
            raise ValueError(f"tensor parallelism over {tp} ranks does not divide the "
                             f"{name} tower's MLP width {hidden}")


def shard_leaf(x, spec, rank: int, tp: int):
    """Rank `rank`'s slice of a full leaf (a new contiguous tensor)."""
    dim = _split_dim(spec)
    if dim is None:
        return x.detach().clone()
    if spec[dim] == QKV_HEADS:
        return torch.cat([shard_leaf(part, (None,) * dim + (MODEL_AXIS,), rank, tp)
                          for part in x.detach().chunk(3, dim=dim)], dim=dim)
    n = x.shape[dim] // tp
    return x.detach().narrow(dim, rank * n, n).contiguous().clone()


def unshard_leaf(parts: list, spec):
    """The full leaf from every rank's slice, by rank."""
    dim = _split_dim(spec)
    if dim is None:
        return parts[0]
    if spec[dim] == QKV_HEADS:
        thirds = [p.chunk(3, dim=dim) for p in parts]
        return torch.cat([torch.cat([t[i] for t in thirds], dim=dim) for i in range(3)], dim=dim)
    return torch.cat(parts, dim=dim)


def _rebuild(like, tree):
    """`tree` in the container `like` came in: a ParamTree stays one."""
    if isinstance(like, ParamTree):
        trainable = any(p.requires_grad for p in like.parameters())
        return ParamTree(tree, trainable=trainable)
    return tree


def shard_clip_params(mesh, params, cfg):
    """This rank's shard of the full CLIP tree `params` (a ParamTree or a
    nested dict of tensors; a ParamTree comes back as one, as trainable as
    it was): each split leaf sliced for the rank's place on the "model"
    line, the rest copied. A ValueError where tp does not divide a tower's
    heads or MLP width, naming both."""
    tp = mesh.axis(MODEL_AXIS)
    full = as_tree(params)
    check_divisible(cfg, full, tp.world)
    specs = clip_param_specs()
    out = _map2(lambda x, spec: shard_leaf(x, spec, tp.rank, tp.world), full, specs)
    return _rebuild(params, out)


def gather_clip_params(mesh, params) -> dict:
    """The full tree from every rank's shard (the inverse of
    shard_clip_params, bit for bit), as a nested dict of detached tensors on
    the shards' device. Collective over the "model" line."""
    tp = mesh.axis(MODEL_AXIS)

    def gather(x, spec):
        x = x.detach().contiguous()
        if _split_dim(spec) is None:
            return x.clone()
        parts = [torch.empty_like(x) for _ in range(tp.world)]
        dist.all_gather(parts, x, group=tp.group)
        return unshard_leaf(parts, spec)

    with torch.no_grad():
        return _map2(gather, as_tree(params), clip_param_specs())


def _map2(fn, tree, specs):
    if isinstance(specs, dict):
        if set(tree) != set(specs):
            raise ValueError(f"the tree's keys {sorted(tree)} are not the CLIP layout's "
                             f"{sorted(specs)}")
        return {k: _map2(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def local_heads(n_heads: int, tp, w_qkv, width: int) -> int:
    """The heads of this rank's block shard; checks that w_qkv is one."""
    if n_heads % tp.world:
        raise ValueError(f"tensor parallelism over {tp.world} ranks does not divide "
                         f"{n_heads} heads")
    if w_qkv.shape[-1] * tp.world != 3 * width:
        raise ValueError(f"the block's w_qkv {tuple(w_qkv.shape)} is not a {tp.world}-way "
                         f"shard of width {width}")
    return n_heads // tp.world


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model line."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model line forward; identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return _summed(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _summed(x, tp):
    total = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(total, group=tp.group)
    return total.to(x.dtype)


def copy_to_model(x, tp):
    """A column-parallel product's input: every rank's full x."""
    return x if tp.world == 1 else _CopyToModel.apply(x, tp)


def reduce_from_model(x, tp):
    """A row-parallel product's output: the sum of the ranks' partial products."""
    return x if tp.world == 1 else _ReduceFromModel.apply(x, tp)


def _pairs(tree, marks):
    """(leaf, mark) of two trees of one layout, walked by `tree`'s keys."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], marks[k])
    else:
        yield tree, marks


def sharded_global_norm(grads, sharded, line):
    """The global norm of `grads` whose leaves marked True in `sharded` (a
    tree of bools of the same layout) are shards over `line` and the rest
    replicated on it: the shards' squares summed over the line, each
    replicated leaf counted once. Collective over `line`."""
    squares = [(torch.linalg.vector_norm(g.float()) ** 2, split)
               for g, split in _pairs(as_tree(grads), sharded)]
    shards = torch.stack([s for s, split in squares if split] or
                         [squares[0][0].new_zeros(())]).sum()
    dist.all_reduce(shards, group=line.group)
    replicated = [s for s, split in squares if not split]
    return torch.sqrt(shards + (torch.stack(replicated).sum() if replicated else 0.0))
