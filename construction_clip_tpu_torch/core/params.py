"""Parameter trees.

The port keeps the JAX package's parameter layout: nested dicts whose leaves are
`[in, out]` weights, with transformer layers stacked along a leading `L` axis.
Model code is plain functions over such a tree of tensors; `ParamTree` holds the
same tree as an `nn.Module` of `nn.Parameter`s, so `.to(device)`,
`state_dict()` and friends work, and its state-dict keys are the JAX tree paths
joined with dots.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def tree_map(fn: Callable, tree):
    """fn over the leaves of nested dicts and lists (the detector's stages and
    FPN levels are lists); a tuple is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def stack_trees(trees: list):
    """Equal numpy trees stacked leaf by leaf along a new leading axis (the
    layer stacks of a converted checkpoint)."""
    import numpy as np

    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def layer(stacked, index: int):
    """Params of one layer of a stacked tree (views, no copy)."""
    return tree_map(lambda z: z[index], stacked)


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters: frozen for serving, or
    `trainable` (floating leaves require grad) for training."""

    def __init__(self, tree: dict, *, trainable: bool = False):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value, trainable=trainable))
            else:
                t = torch.as_tensor(value)
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=trainable and t.is_floating_point()))

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.tree() for name, m in self.named_children()})
        return out


def as_tree(params) -> dict:
    """A ParamTree's nested dict of tensors; a dict is returned as it is."""
    return params.tree() if isinstance(params, ParamTree) else params
