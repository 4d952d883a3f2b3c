"""PyTorch port, the sharded checkpoint round trip against the JAX package:
a TP-sharded TrainState (the CLIP tree's Megatron shards over the "model"
line of a TP(2) x DP(4) mesh of 8 ranks) saves, restores with its values
and step intact, and the restored state steps under make_gspmd_train_step
as the live one does; the file is the one-device format, which one process
and another layout restore; two steps with the round trip between them
match JAX's make_gspmd_train_step on the same mesh of conftest's virtual
devices.

The JAX test (tests/test_checkpoint_sharded.py) runs TP(4) x DP(2); the
port splits whole heads and the tiny config has 2 a tower, so the port's
mesh is TP(2) x DP(4), and JAX runs the same mesh here.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous), one spawn for every case. This module imports no JAX at its
top."""

import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, create_mesh, shard_batch, spawn_ranks)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.parallel.sharding import gather_clip_params, shard_clip_params
from construction_clip_tpu_torch.train import checkpoint, contrastive
from construction_clip_tpu_torch.train.state import TrainState, make_adamw

CFG = CLIPConfig.tiny()
AXES = {DATA_AXIS: 4, MODEL_AXIS: 2}
WORLD = 8
LR = 1e-3
ADAMW = dict(warmup_steps=0, total_steps=100)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), as_tree(tree))


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(as_tree(a)), tree_leaves(as_tree(b))))


def _same_values(a, b) -> bool:
    """Numpy trees equal leaf by leaf, matched by key."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_values(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def _moments(opt_state):
    return opt_state["m"], opt_state["v"]


# ---- what each spawned rank runs -------------------------------------------------------

def _fresh(mesh, case, shift):
    """A sharded state whose values are not the checkpoint's (params + shift)."""
    tree = tree_map(lambda a: a + np.float32(shift), case["params"])
    tx = make_adamw(LR, **ADAMW)
    return TrainState.create(shard_clip_params(mesh, convert.to_params(tree, trainable=True),
                                               CFG), tx), tx


def _ckpt_rank(mesh, case, directory):
    data = mesh.axis(DATA_AXIS)
    rows = [shard_batch(data, {k: torch.from_numpy(v) for k, v in b.items()})
            for b in case["batches"]]
    live, tx = _fresh(mesh, case, 0.0)
    step = contrastive.make_gspmd_train_step(CFG, tx, mesh)
    live, m1 = step(live, rows[0])
    checkpoint.save_state(directory, live, mesh=mesh)
    saved = {"params": _np(gather_clip_params(mesh, live.params)),
             "m": _np(gather_clip_params(mesh, live.opt_state["m"])),
             "v": _np(gather_clip_params(mesh, live.opt_state["v"]))}

    fresh, _ = _fresh(mesh, case, 1.0)
    restored = checkpoint.restore_state(directory, fresh, mesh=mesh, cfg=CFG)
    out = {"saved": saved, "step": restored.step, "count": restored.opt_state["count"],
           "params_equal": _equal(restored.params, live.params),
           "moments_equal": all(_equal(a, b) for a, b in zip(_moments(restored.opt_state),
                                                             _moments(live.opt_state)))}
    resumed, m2 = step(restored, rows[1])
    live, m2_live = step(live, rows[1])
    out["losses"] = [float(m1["loss"]), float(m2["loss"]), float(m2_live["loss"])]
    out["resumed_step"] = resumed.step
    out["resumed_equals_live"] = _equal(resumed.params, live.params)
    out["resumed"] = _np(gather_clip_params(mesh, resumed.params))

    # another layout over the same world: TP(1) x DP(8) restores the whole tree
    other = create_mesh({DATA_AXIS: WORLD, MODEL_AXIS: 1}, device="cpu")
    fresh, _ = _fresh(other, case, 2.0)
    whole = checkpoint.restore_state(directory, fresh, mesh=other, cfg=CFG)
    out["other_layout_equal"] = _same_values(_np(whole.params), saved["params"])
    other.close()
    return out


# ---- against one process and the JAX package ---------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.core import mesh as jmesh
    from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
    from construction_clip_tpu.models.clip import init_clip
    from construction_clip_tpu.parallel.sharding import shard_clip_params as jshard
    from construction_clip_tpu.train.contrastive import make_gspmd_train_step
    from construction_clip_tpu.train import state as jstate

    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def case(jx):
    gen = np.random.default_rng(11)
    batches = []
    for _ in range(2):
        toks = np.zeros((8, CFG.text.context_length), np.int32)
        toks[:, 0] = 1
        toks[:, 1:6] = gen.integers(3, 200, (8, 5))
        toks[:, 6] = 255   # EOT, the largest id
        batches.append({"images": gen.standard_normal(
            (8, CFG.vision.image_size, CFG.vision.image_size, 3)).astype(np.float32),
            "tokens": toks})
    params = jx.jax.tree.map(lambda a: np.asarray(a, np.float32),
                             jx.init_clip(jx.jax.random.key(0), jx.JCLIPConfig.tiny()))
    return {"params": params, "batches": batches}


@pytest.fixture(scope="module")
def run(case, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return directory, spawn_ranks(_ckpt_rank, WORLD, (case, directory), device="cpu",
                                  timeout=60, axes=AXES)


def test_restored_state_has_the_saved_values_and_step(run):
    """Every rank's restored shard equals its live shard bit for bit, params
    and AdamW's moments, with the step and the optimizer count."""
    _, ranks = run
    for rank in ranks:
        assert rank["step"] == 1 and rank["count"] == 1
        assert rank["params_equal"] and rank["moments_equal"]


def test_restored_state_steps_as_the_live_one(run):
    """The restored state steps under the same make_gspmd_train_step: step 2,
    the live state's loss and params, bit for bit, on every rank."""
    _, ranks = run
    for rank in ranks:
        assert rank["resumed_step"] == 2
        assert rank["losses"][1] == rank["losses"][2] and np.isfinite(rank["losses"]).all()
        assert rank["resumed_equals_live"]
    for rank in ranks[1:]:
        assert _same_values(rank["resumed"], ranks[0]["resumed"])


def test_the_file_is_the_one_device_format(run):
    """One process restores the file into an unsharded state: the full params
    and moments the ranks gathered, exactly, matched by key (the file lists
    the gathered tree's keys in another order than convert.init_clip's) and
    the moments laid out in the params' order, as AdamW pairs them."""
    directory, ranks = run
    assert checkpoint.latest_step(directory) == 1
    tx = make_adamw(LR, **ADAMW)
    st = TrainState.create(convert.to_params(convert.init_clip(5, CFG), trainable=True), tx)
    st = checkpoint.restore_state(directory, st)
    assert st.step == 1
    for name, tree in (("params", st.params), ("m", st.opt_state["m"]),
                       ("v", st.opt_state["v"])):
        assert _same_values(_np(tree), ranks[0]["saved"][name])
        assert _key_order(as_tree(tree)) == _key_order(as_tree(st.params))


def _key_order(tree):
    return [(k, _key_order(v)) for k, v in tree.items()] if isinstance(tree, dict) else None


def test_another_layout_restores_the_file(run):
    """TP(1) x DP(8), laid over the same ranks, restores the whole tree."""
    _, ranks = run
    assert all(rank["other_layout_equal"] for rank in ranks)


def _noise_aware_close(got, want, grads, steps, lr, path=""):
    """Params to 2e-6 absolute, except elements whose first gradient lies
    below 1e-4 of its leaf's largest, where fp32 rounding in sums of another
    order is a sizeable part of the element and Adam normalises it into
    updates of up to lr a step of either sign (2 lr a step apart). Returns
    (elements held to 2e-6, elements)."""
    if isinstance(want, dict):
        counts = [_noise_aware_close(got[k], want[k], grads[k], steps, lr, f"{path}/{k}")
                  for k in want]
        return tuple(map(sum, zip(*counts)))
    g = np.abs(np.asarray(grads))
    noise = g < 1e-4 * g.max()
    atol = np.where(noise, 2 * steps * lr, 2e-6)
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= atol).all(), (path, float(err.max()), float((err - atol).max()))
    return int((~noise).sum()), noise.size


def test_round_trip_steps_match_jax(jx, case, run):
    """Step, save, restore, step against JAX's two make_gspmd_train_step
    steps (make_adamw) on the same TP(2) x DP(4) mesh: the losses to 1e-5
    relative and the params as `_noise_aware_close` holds them (the first
    gradient: JAX's, from its first step's first moment m = (1 - b1) g)."""
    _, ranks = run
    mesh = jx.jmesh.create_mesh(AXES)
    tx = jx.jstate.make_adamw(LR, **ADAMW)
    st = jx.jstate.TrainState.create(
        jx.jshard(mesh, jx.jax.tree.map(jx.jnp.asarray, case["params"])), tx)
    step = jx.make_gspmd_train_step(jx.JCLIPConfig.tiny(), tx, mesh)
    losses, grads = [], None
    for b in case["batches"]:
        st, m = step(st, jx.jmesh.shard_batch(mesh, b))
        losses.append(float(m["loss"]))
        if grads is None:
            grads = jx.jax.tree.map(lambda a: np.asarray(a) / 0.1, st.opt_state["m"])
    for rank in ranks:
        np.testing.assert_allclose(rank["losses"][:2], losses, rtol=1e-5)
    held, total = _noise_aware_close(ranks[0]["resumed"], jx.jax.tree.map(np.asarray, st.params),
                                     grads, 2, LR)
    assert held >= 0.9 * total
