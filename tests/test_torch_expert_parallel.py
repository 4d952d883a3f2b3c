"""PyTorch port, expert parallelism against the JAX package: the top-1
routed MoE FFN over the "expert" line (parallel/expert.py) at EP(8) and
EP(4) x DP(2), forward and gradients, against JAX's moe_ffn_dense and
moe_ffn_ep on the same meshes of conftest's virtual devices; the
group-local capacity drops; the routing and the dense reference op by op;
the expert shards; JAX's MoE tree carried across by convert.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous): one spawn of 8 ranks runs every case, the EP(4) x DP(2) mesh
laid over the same world. This module imports no JAX at its top."""

import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.mesh import DATA_AXIS, create_mesh, spawn_ranks
from construction_clip_tpu_torch.parallel import expert
from construction_clip_tpu_torch.parallel.expert import EXPERT_AXIS

D, F, E = 16, 32, 8
WORLD = 8
LAYOUTS = {"ep8": ({EXPERT_AXIS: 8}, None), "ep4_dp2": ({EXPERT_AXIS: 4, DATA_AXIS: 2}, DATA_AXIS)}


# ---- what each spawned rank runs -------------------------------------------------------

def _layout_case(mesh, dp_axis, case):
    full = {k: torch.from_numpy(np.array(v)) for k, v in case["params"].items()}
    local = {k: v.requires_grad_() for k, v in expert.shard_experts(mesh, full).items()}
    x = expert.shard_tokens(mesh, torch.from_numpy(case["x"]), dp_axis=dp_axis)
    tgt = expert.shard_tokens(mesh, torch.from_numpy(case["tgt"]), dp_axis=dp_axis)
    y = expert.moe_ffn_ep(local, x, mesh, capacity_factor=float(E), dp_axis=dp_axis)
    # each rank's part of the mean over every token: its squares over the global count
    loss = ((y - tgt) ** 2).sum() / case["tgt"].size
    grads = dict(zip(local, torch.autograd.grad(loss, list(local.values()))))
    expert.reduce_grads(grads, mesh, dp_axis=dp_axis)
    with torch.no_grad():
        tight = expert.moe_ffn_ep(local, x, mesh, capacity_factor=1.0, dp_axis=dp_axis)
    return {"group": expert.token_group(mesh, EXPERT_AXIS, dp_axis)[0],
            "expert_coord": mesh.coords[EXPERT_AXIS],
            "shapes": {k: tuple(v.shape) for k, v in local.items()},
            "y": y.detach().numpy(), "tight": tight.numpy(),
            "grads": {k: g.numpy() for k, g in grads.items()}}


def _ep_rank(mesh, case):
    out = {"ep8": _layout_case(mesh, None, case)}
    other = create_mesh(LAYOUTS["ep4_dp2"][0], device="cpu")
    out["ep4_dp2"] = _layout_case(other, DATA_AXIS, case)
    other.close()
    return out


# ---- against the JAX package --------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.core import mesh as jmesh
    from construction_clip_tpu.parallel import expert as jexpert

    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def case(jx):
    params = jx.jax.tree.map(np.asarray, jx.jexpert.init_moe(jx.jax.random.key(3), D, F, E))
    x = np.random.default_rng(5).standard_normal((8, 4, D)).astype(np.float32)
    tgt = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    return {"params": params, "x": x, "tgt": tgt}


@pytest.fixture(scope="module")
def ranks(case):
    return spawn_ranks(_ep_rank, WORLD, (case,), device="cpu", timeout=60,
                       axes=LAYOUTS["ep8"][0])


def _by_group(ranks, layout, key):
    """The ranks' [S, D] outputs in group order, as [B, T, D]."""
    parts = sorted((r[layout]["group"], r[layout][key]) for r in ranks)
    return np.concatenate([p for _, p in parts]).reshape(8, 4, D)


def _jax_mesh(jx, layout):
    return jx.jmesh.create_mesh(LAYOUTS[layout][0])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ep_matches_dense_forward(jx, case, ranks, layout):
    """The groups' outputs with no drops (capacity_factor = E) against JAX's
    moe_ffn_dense and JAX's moe_ffn_ep on the same mesh (JAX's tolerance,
    rtol 2e-5, atol 1e-6); the routing is sparse: every expert used, none
    by everything."""
    params = jx.jax.tree.map(jx.jnp.asarray, case["params"])
    dense = jx.jexpert.moe_ffn_dense(params, case["x"])
    ep = jx.jexpert.moe_ffn_ep(params, case["x"], _jax_mesh(jx, layout),
                               capacity_factor=float(E), dp_axis=LAYOUTS[layout][1])
    got = _by_group(ranks, layout, "y")
    for want in (dense, ep):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=1e-6)
    probs = jx.jax.nn.softmax(case["x"].reshape(-1, D) @ case["params"]["router"], axis=-1)
    counts = np.bincount(np.asarray(jx.jnp.argmax(probs, -1)), minlength=E)
    assert counts.max() < 32 and (counts > 0).sum() >= E // 2


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ep_grads_match_dense(jx, case, ranks, layout):
    """The gradients flow back through the combine and dispatch einsums and
    both all_to_alls; the router's summed over every rank and the experts'
    over the data line (reduce_grads) equal jax.grad of the dense loss (JAX's
    tolerance, rtol 5e-5, atol 1e-7): the router on every rank, each rank's
    expert shard its own slice."""
    params = jx.jax.tree.map(jx.jnp.asarray, case["params"])
    want = jx.jax.grad(lambda p: jx.jnp.mean(
        (jx.jexpert.moe_ffn_dense(p, case["x"]) - case["tgt"]) ** 2))(params)
    ed = LAYOUTS[layout][0][EXPERT_AXIS]
    n = E // ed
    for rank in ranks:
        r = rank[layout]
        for k, g in r["grads"].items():
            w = np.asarray(want[k])
            if k != "router":
                w = w[r["expert_coord"] * n:(r["expert_coord"] + 1) * n]
            np.testing.assert_allclose(g, w, rtol=5e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ep_capacity_drops_are_group_local(jx, case, ranks, layout):
    """capacity_factor 1.0 (C = ceil(S / E) slots): the dropped tokens' rows
    are exactly zero, something is dropped and something kept, the kept rows
    match the dense compute of those tokens (2e-5), and the drops are JAX's
    moe_ffn_ep's on the same mesh, row for row."""
    params = jx.jax.tree.map(jx.jnp.asarray, case["params"])
    got = _by_group(ranks, layout, "tight").reshape(-1, D)
    ref = np.asarray(jx.jexpert.moe_ffn_dense(params, case["x"])).reshape(-1, D)
    theirs = np.asarray(jx.jexpert.moe_ffn_ep(params, case["x"], _jax_mesh(jx, layout),
                                              capacity_factor=1.0,
                                              dp_axis=LAYOUTS[layout][1])).reshape(-1, D)
    dropped = np.all(got == 0.0, axis=-1)
    assert dropped.any() and not dropped.all()
    assert (dropped == np.all(theirs == 0.0, axis=-1)).all()
    np.testing.assert_allclose(got[~dropped], ref[~dropped], rtol=2e-5, atol=1e-6)


def test_ep_params_actually_sharded(ranks):
    """Each rank holds E / Ed experts of each stack and the whole router: one
    expert at EP(8), two at EP(4) x DP(2)."""
    for rank in ranks:
        for layout, n in (("ep8", 1), ("ep4_dp2", 2)):
            assert rank[layout]["shapes"] == {"router": (D, E), "w_in": (n, D, F),
                                              "b_in": (n, F), "w_out": (n, F, D),
                                              "b_out": (n, D)}


def test_route_and_dense_match_jax_op_by_op(jx, case):
    """_route (dispatch and gate, with and without drops) and moe_ffn_dense
    in one process against JAX's, on the same params."""
    params = {k: torch.from_numpy(np.array(v)) for k, v in case["params"].items()}
    jparams = jx.jax.tree.map(jx.jnp.asarray, case["params"])
    tokens = case["x"].reshape(-1, D)
    for capacity in (32, 4, 1):
        d, g = expert._route(torch.from_numpy(tokens), params["router"], E, capacity)
        jd, jg = jx.jexpert._route(tokens, jparams["router"], E, capacity)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
        got = expert.moe_ffn_dense(params, torch.from_numpy(case["x"]), capacity=capacity)
        want = jx.jexpert.moe_ffn_dense(jparams, case["x"], capacity=capacity)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-6)


def test_convert_carries_the_jax_moe_tree(jx, case):
    """convert.to_params copies JAX's init_moe tree leaf for leaf, and the
    port's numpy init_moe has its shapes, dtypes and scales (other draws)."""
    tree = convert.to_params(case["params"]).tree()
    assert set(tree) == set(case["params"])
    for k, v in case["params"].items():
        np.testing.assert_array_equal(tree[k].numpy(), v)
    ours = expert.init_moe(3, D, F, E)
    for k, v in case["params"].items():
        assert ours[k].shape == v.shape and ours[k].dtype == v.dtype
        if k.startswith("b_"):
            assert not ours[k].any() and not v.any()
        else:
            np.testing.assert_allclose(ours[k].std(), v.std(), rtol=0.15)
