"""Expert parallelism: a top-1 routed mixture-of-experts FFN sharded over the
mesh's "expert" line, tokens exchanged by all_to_all (counterpart of
construction_clip_tpu/parallel/expert.py).

  * The line holds Ed ranks; E experts (E % Ed == 0) are stacked on a
    leading axis, and rank j owns experts [j E/Ed, (j+1) E/Ed)
    (`shard_experts`). The router projection is small and replicated.
  * Tokens are grouped by rank (GShard's groups, `shard_tokens`): each rank
    routes its S tokens top-1 into C slots per expert, first come first
    served in token order; a token past its expert's C slots is dropped
    (its gate zeroed, its output row zero). The drops are group-local: a
    token competes only with its own group's.
  * Dispatch is one einsum to [E, C, D]; one all_to_all re-buckets the
    slots by owner; the owned experts run as batched products over every
    group's slots; the reverse all_to_all and the combine einsum bring the
    gated outputs home. `_AllToAll`'s backward is the reverse all_to_all.
  * With a data axis beside it (`dp_axis`), each data line holds a replica
    of the experts and routes its own groups; `reduce_grads` sums the
    router's gradient over every rank and the experts' over the data line,
    as JAX's transpose of the replicated inputs does.
The products are cuBLAS einsums and the activation is gelu_new: no hand
kernel, as the JAX package's path reaches no Pallas call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from construction_clip_tpu_torch.ops.activations import gelu_new as gelu

EXPERT_AXIS = "expert"


def init_moe(seed: int, d_model: int, d_ff: int, n_experts: int, dtype=np.float32) -> dict:
    """MoE FFN params at the JAX init_moe's shapes and scales (numpy-seeded,
    so other numbers than jax.random's): the replicated router [D, E] and the
    expert-stacked [E, in, out] projections."""
    rng = np.random.default_rng(seed)
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": (rng.standard_normal((d_model, n_experts)) * s_in).astype(dtype),
        "w_in": (rng.standard_normal((n_experts, d_model, d_ff)) * s_in).astype(dtype),
        "b_in": np.zeros((n_experts, d_ff), dtype),
        "w_out": (rng.standard_normal((n_experts, d_ff, d_model)) * s_out).astype(dtype),
        "b_out": np.zeros((n_experts, d_model), dtype),
    }


def _route(x, router, n_experts: int, capacity: int):
    """Top-1 routing of one group of S tokens -> (dispatch [S, E, C], gate
    [S]), first come first served (token order, the Switch/GShard
    tie-break)."""
    probs = torch.softmax((x @ router).float(), dim=-1)                # [S, E]
    expert = probs.argmax(dim=-1)                                      # [S]
    gate = probs.gather(-1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n_experts).float()    # [S, E]
    pos = (torch.cumsum(onehot, dim=0) * onehot - onehot).sum(-1).long()   # queue place
    keep = (pos < capacity).float()
    slot = torch.nn.functional.one_hot(pos.clamp(max=capacity - 1), capacity).float()
    dispatch = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
    return dispatch, gate * keep


def moe_ffn_dense(params, x, *, capacity: int | None = None):
    """One process's reference: the same routed FFN with a per-token weight
    gather, the semantics the expert-parallel FFN reproduces. x [B, T, D]."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    n_experts = params["router"].shape[-1]
    capacity = capacity if capacity is not None else b * t
    dispatch, gate = _route(tokens, params["router"], n_experts, capacity)
    expert = dispatch.sum(-1).argmax(dim=-1)                 # [S] (0 where dropped)
    kept = (dispatch.sum((1, 2)) > 0).float()
    h = gelu(torch.einsum("sd,sdf->sf", tokens, params["w_in"][expert])
             + params["b_in"][expert])
    y = torch.einsum("sf,sfd->sd", h, params["w_out"][expert]) + params["b_out"][expert]
    return (y * (gate * kept)[:, None]).reshape(b, t, d)


class _AllToAll(torch.autograd.Function):
    """Row block j to the line's rank j; backward: the reverse exchange."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.line = line
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=line.group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.line.group)
        return out, None


def token_group(mesh, axis: str = EXPERT_AXIS, dp_axis: str | None = None) -> tuple:
    """(this rank's group, the number of groups): JAX's token spec
    P((dp_axis, axis)), the data coordinate the major one."""
    ed = mesh.axis(axis)
    if dp_axis is None:
        return ed.rank, ed.world
    dp = mesh.axis(dp_axis)
    return dp.rank * ed.world + ed.rank, dp.world * ed.world


def shard_tokens(mesh, x, *, axis: str = EXPERT_AXIS, dp_axis: str | None = None):
    """This rank's group of the global tokens x [B, T, D]: the rows of the
    flattened [B T, D] that JAX's moe_ffn_ep gives its device."""
    b, t, d = x.shape
    group, n_groups = token_group(mesh, axis, dp_axis)
    if (b * t) % n_groups:
        raise ValueError(f"{b * t} tokens not divisible by {n_groups} groups")
    s = b * t // n_groups
    return x.reshape(b * t, d)[group * s:(group + 1) * s]


def shard_experts(mesh, params, *, axis: str = EXPERT_AXIS) -> dict:
    """This rank's experts (the router replicated): each [E, ...] leaf
    sliced to [E/Ed, ...]."""
    ed = mesh.axis(axis)
    n_experts = params["router"].shape[-1]
    if n_experts % ed.world:
        raise ValueError(f"{n_experts} experts not divisible by {axis}={ed.world}")
    n = n_experts // ed.world
    return {k: v.detach().clone() if k == "router" else
            v.detach()[ed.rank * n:(ed.rank + 1) * n].clone() for k, v in params.items()}


def moe_ffn_ep(params, x, mesh, *, capacity_factor: float = 1.0, axis: str = EXPERT_AXIS,
               dp_axis: str | None = None):
    """The expert-parallel FFN of this rank's group of tokens x [S, D]
    (shard_tokens) through this rank's experts (shard_experts): -> [S, D].
    capacity_factor: C = ceil(S capacity_factor / E) slots per expert per
    group; E or more drops nothing (equal to moe_ffn_dense)."""
    ed = mesh.axis(axis)
    if dp_axis is not None:
        mesh.axis(dp_axis)
    n_experts = params["router"].shape[-1]
    e_local = params["w_in"].shape[0]
    if e_local * ed.world != n_experts:
        raise ValueError(f"{n_experts} experts not divisible by {axis}={ed.world}, or "
                         f"the params hold {e_local} experts, not this rank's shard")
    s, d = x.shape
    capacity = -(-int(s * capacity_factor) // n_experts)   # ceil
    dispatch, gate = _route(x, params["router"], n_experts, capacity)
    xe = torch.einsum("sec,sd->ecd", dispatch, x)           # [E, C, D]
    # row block j goes to rank j, which then holds every group's slots of its experts
    xe = _AllToAll.apply(xe.reshape(ed.world * e_local * capacity, d), ed)
    xe = xe.reshape(ed.world, e_local, capacity, d).transpose(0, 1) \
        .reshape(e_local, ed.world * capacity, d)
    h = gelu(torch.einsum("ecd,edf->ecf", xe, params["w_in"]) + params["b_in"][:, None, :])
    ye = torch.einsum("ecf,efd->ecd", h, params["w_out"]) + params["b_out"][:, None, :]
    ye = ye.reshape(e_local, ed.world, capacity, d).transpose(0, 1) \
        .reshape(ed.world * e_local * capacity, d)
    ye = _AllToAll.apply(ye, ed).reshape(n_experts, capacity, d)
    return torch.einsum("sec,ecd,s->sd", dispatch, ye, gate)


def reduce_grads(grads: dict, mesh, *, axis: str = EXPERT_AXIS,
                 dp_axis: str | None = None) -> dict:
    """The gradients of a loss over every group, from each rank's gradients
    of its own groups' part: the router's summed over every rank (the expert
    line, then the data line), the experts' over the data line (each data
    line's replica saw its own groups). In place; returns `grads`."""
    lines = [mesh.axis(axis)] + ([mesh.axis(dp_axis)] if dp_axis is not None else [])
    for line in lines:
        dist.all_reduce(grads["router"], group=line.group)
    for k, g in grads.items():
        if k != "router" and dp_axis is not None:
            dist.all_reduce(g, group=lines[1].group)
    return grads
