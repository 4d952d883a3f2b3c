"""Checkpoint and resume (counterpart of construction_clip_tpu/train/checkpoint.py).

A checkpoint is the whole TrainState (step, params, optimizer state) in one
`torch.save` file, `<dir>/step_<N>.pt`, written to a temporary name and renamed,
so a crash never leaves a torn latest checkpoint. `save_params_npz` writes the
inference artifact with the JAX package's flat keys ("vision/blocks/ln_1/scale"),
so that package's `load_params_npz` and `apps/predict.py` read what the port
trains; `load_params_npz` reads it back against a template, as that
package's does.

Data-parallel (`dp`, core/mesh.py), the replicas are equal, so only rank 0
writes, and every rank waits at a barrier until the file is there; every
rank restores from it.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def save_state(directory: str, state: TrainState, *, step: Optional[int] = None,
               max_to_keep: int = 5, dp=None) -> int:
    """Save a TrainState under `step` (its own step when None), keeping the
    newest `max_to_keep`. Returns the step used. With `dp`, rank 0 writes and
    every rank leaves once it has."""
    step = state.step if step is None else int(step)
    if dp is not None:
        if dp.rank == 0:
            save_state(directory, state, step=step, max_to_keep=max_to_keep)
        dp.barrier()
        return step
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": state.step,
                "params": tree_map(torch.Tensor.detach, as_tree(state.params)),
                "opt_state": state.opt_state}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"step_{old}.pt"))
    return step


def restore_state(directory: str, state: TrainState, *, step: Optional[int] = None
                  ) -> TrainState:
    """Load a checkpoint into `state`'s params (in place, on their device) and
    return the TrainState with its optimizer state and step. step=None -> latest."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    saved = torch.load(os.path.join(directory, f"step_{step}.pt"), map_location="cpu",
                       weights_only=True)
    params = as_tree(state.params)
    with torch.no_grad():
        for dst, src in zip(tree_leaves(params), tree_leaves(saved["params"])):
            dst.copy_(src)
    device = tree_leaves(params)[0].device

    def to_device(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (tuple, list)):
            return type(x)(to_device(y) for y in x)
        return tree_map(to_device, x) if isinstance(x, dict) else x

    return TrainState(step=saved["step"], params=state.params,
                      opt_state=to_device(saved["opt_state"]))


def _flat(tree, prefix=""):
    """(key, leaf) of nested dicts and lists, the JAX package's keys: a list
    item's key is its index ("backbone/stages/0/1/conv1")."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        name = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            yield from _flat(value, name + "/")
        else:
            yield name, value


def _numpy(v) -> np.ndarray:
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    v = v.detach()
    return (v.float() if v.is_floating_point() else v).cpu().numpy()


def save_params_npz(path: str, params, dp=None) -> None:
    """Flat portable dump of the params, keys as the JAX package writes them.
    With `dp`, rank 0 writes and every rank leaves once it has."""
    if dp is not None:
        if dp.rank == 0:
            save_params_npz(path, params)
        dp.barrier()
        return
    np.savez(path, **{k: _numpy(v) for k, v in _flat(as_tree(params))})


def load_params_npz(path: str, template) -> dict:
    """The params that `save_params_npz` (of either package) wrote, as a
    nested dict of numpy arrays in the structure of `template` (a tree of the
    config's `convert.init_*`, `convert.SHAPES` for its shapes alone), each
    leaf cast to the template's dtype; `convert.to_params` makes it a
    ParamTree. A key the file lacks, or a leaf of another shape, is an error
    that names the key."""
    with np.load(path, allow_pickle=False) as data:
        def load(key, want):
            if key not in data.files:
                raise KeyError(f"{path}: no parameter {key!r} (another architecture "
                               f"or config?)")
            arr = data[key]
            if arr.shape != want.shape:
                raise ValueError(f"{path}: parameter {key!r} has shape {arr.shape}, the "
                                 f"config wants {want.shape}")
            return arr.astype(want.dtype)

        def walk(node, prefix):
            if isinstance(node, list):
                return [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
            return load(prefix[:-1], np.asarray(node))

        return walk(template, "")
