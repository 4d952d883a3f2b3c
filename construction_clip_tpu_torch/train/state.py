"""Train state and optimizers (counterpart of construction_clip_tpu/train/state.py).

Trees are nested dicts of tensors in the JAX layout (`core.params.as_tree`).
Unlike the JAX package, whose arrays are immutable, the optimizers here update
the parameters and their moments IN PLACE under `torch.no_grad()`: one pass
over each leaf, and no second copy of the parameters or of the optimizer state.
`apply_gradients` therefore returns a TrainState that shares its tensors with
the one it was given.

A step whose gradients are shards (tensor- or pipeline-parallel) applies
them under `global_norm_rule`, so that `clip_by_global_norm` takes the norm
of the whole tree and not of the rank's part of it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable

import torch

from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any       # a ParamTree (trainable) or a nested dict of tensors
    opt_state: Any

    @staticmethod
    def create(params, tx) -> "TrainState":
        return TrainState(step=0, params=params, opt_state=tx.init(as_tree(params)))


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """init(params) -> state; update(grads, state, params) -> (updates, state)."""

    init: Callable
    update: Callable


@dataclasses.dataclass(frozen=True)
class FusedOptimizer(GradientTransformation):
    """Also `update_and_apply(grads, state, params) -> (params, state)`, which
    folds p - lr*u into the same per-leaf pass as the moment updates."""

    update_and_apply: Callable = None


def apply_gradients(state: TrainState, grads, tx) -> TrainState:
    params = as_tree(state.params)
    with tracing.span("optimizer"):
        if hasattr(tx, "update_and_apply"):
            _, opt_state = tx.update_and_apply(grads, state.opt_state, params)
        else:
            updates, opt_state = tx.update(grads, state.opt_state, params)
            with torch.no_grad():
                torch._foreach_add_(tree_leaves(params), tree_leaves(updates))
    return TrainState(step=state.step + 1, params=state.params, opt_state=opt_state)


def linear_warmup_schedule(lr: float, warmup_steps: int, total_steps: int) -> Callable:
    """HF get_linear_schedule_with_warmup semantics: linear 0->lr over warmup, then
    linear decay lr->0 over the remainder."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return lr * step / max(1.0, warmup_steps)
        return lr * max(0.0, (total_steps - step) / max(1.0, total_steps - warmup_steps))
    return schedule


def fused_adamw(schedule, *, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> FusedOptimizer:
    """AdamW as optax.adamw(schedule) computes it (bias correction with count+1,
    decay added before the lr scaling, lr taken at the pre-increment count), as
    one in-place pass per leaf with torch._foreach_* ops. The moments `m` and
    `v` are updated in place; `update` returns the updates -lr*u, and
    `update_and_apply` also subtracts lr*u from the parameters in place."""

    def init(params):
        return {"count": 0, "m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def _run(grads, state, params, apply: bool):
        count = state["count"]
        bc1 = 1.0 - b1 ** (count + 1)
        bc2 = 1.0 - b2 ** (count + 1)
        lr_t = float(schedule(count))
        g = tree_leaves(grads)
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        denom = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, denom)
        if weight_decay:
            torch._foreach_add_(u, tree_leaves(params), alpha=weight_decay)
        new_state = {"count": count + 1, "m": state["m"], "v": state["v"]}
        if apply:
            torch._foreach_add_(tree_leaves(params), u, alpha=-lr_t)
            return params, new_state
        torch._foreach_mul_(u, -lr_t)
        return _unflatten(grads, u), new_state

    def update(grads, state, params=None):
        return _run(grads, state, params, apply=False)

    def update_and_apply(grads, state, params):
        return _run(grads, state, params, apply=True)

    return FusedOptimizer(init, update, update_and_apply)


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


_NORM_RULE = contextvars.ContextVar("global_norm_rule", default=None)


@contextlib.contextmanager
def global_norm_rule(norm_fn: Callable):
    """Within it, clip_by_global_norm takes the global norm from
    norm_fn(grads): a sharded step's rule, which sums the shards' squares
    over their line (parallel/sharding.sharded_global_norm)."""
    token = _NORM_RULE.set(norm_fn)
    try:
        yield
    finally:
        _NORM_RULE.reset(token)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: scale every leaf by max_norm / ||g|| when the
    global norm exceeds max_norm (the norm by global_norm_rule's function
    within one)."""

    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        rule = _NORM_RULE.get()
        norm = rule(grads) if rule is not None else torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in leaves]))
        clipped = [torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm)
                   for g in leaves]
        return _unflatten(grads, clipped), state

    return GradientTransformation(lambda params: (), update)


def chain(*parts) -> GradientTransformation:
    """optax.chain: each part's updates feed the next; the state is a tuple."""

    def init(params):
        return tuple(p.init(params) for p in parts)

    def update(grads, state, params=None):
        new_state = []
        for part, s in zip(parts, state):
            grads, s = part.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def make_adamw(lr: float = 1e-5, *, warmup_steps: int = 5000, total_steps: int = 100_000,
               weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8, grad_clip: float | None = None) -> GradientTransformation:
    sched = linear_warmup_schedule(lr, warmup_steps, total_steps)
    adamw = fused_adamw(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if grad_clip is None:
        return adamw
    return chain(clip_by_global_norm(grad_clip), adamw)


def adam(lr: float) -> FusedOptimizer:
    """optax.adam(lr): the fused_adamw pass at a constant lr, no weight decay
    (the show-attend-tell apps' optimizer)."""
    return fused_adamw(lambda step: lr)
