"""Checkpoint and resume (counterpart of construction_clip_tpu/train/checkpoint.py).

A checkpoint is the whole TrainState (step, params, optimizer state) in one
`torch.save` file, `<dir>/step_<N>.pt`, written to a temporary name and renamed,
so a crash never leaves a torn latest checkpoint. `save_params_npz` writes the
inference artifact with the JAX package's flat keys ("vision/blocks/ln_1/scale"),
so that package's `load_params_npz` and `apps/predict.py` read what the port
trains.
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
               max_to_keep: int = 5) -> int:
    """Save a TrainState under `step` (its own step when None), keeping the
    newest `max_to_keep`. Returns the step used."""
    step = state.step if step is None else int(step)
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
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flat(value, name + "/")
        else:
            yield name, value


def save_params_npz(path: str, params) -> None:
    """Flat portable dump of the params, keys as the JAX package writes them."""
    np.savez(path, **{k: v.detach().float().cpu().numpy() if v.is_floating_point()
                      else v.detach().cpu().numpy()
                      for k, v in _flat(as_tree(params))})


def load_params_npz(path: str) -> dict:
    """The nested dict of numpy arrays that `save_params_npz` (of either package)
    wrote; `convert.to_params` makes it a ParamTree."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
