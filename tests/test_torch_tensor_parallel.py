"""PyTorch port, tensor parallelism against the JAX package: the named
process mesh (core/mesh.create_mesh) against JAX's create_mesh, the
head-aligned shard of the CLIP tree and its gather (parallel/sharding.py),
the tp-does-not-divide-heads refusal, and the TP x DP forward and train
step (train/contrastive.make_gspmd_train_step) at TP(2) x DP(2) and TP(4)
against JAX's GSPMD step on conftest's virtual devices, with a gradient clip
and with remat.

On create_mesh's default layout (a model line of one rank) the GSPMD step
is make_train_step's, bit for bit.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous); one spawn of 4 ranks runs every case, the TP(4) mesh and the
default layout laid over the same world. This module imports no JAX at its top: the tests import it
where they need it."""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig, TextConfig, VisionConfig
from construction_clip_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_lines, create_mesh, resolve_axis_sizes, shard_batch,
    spawn_ranks)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.models.clip.model import encode_image, encode_text
from construction_clip_tpu_torch.parallel import sharding
from construction_clip_tpu_torch.train import contrastive, state

# the JAX test's config (tests/test_tensor_parallel.py), and one with 4 heads a
# tower for TP(4), which the port cannot split at 2 heads
CFG = CLIPConfig(
    vision=VisionConfig(image_size=16, patch_size=4, width=32, layers=2, heads=2, embed_dim=16),
    text=TextConfig(vocab_size=64, context_length=8, width=32, layers=2, heads=2, embed_dim=16),
)
CFG4 = CLIPConfig(
    vision=VisionConfig(image_size=16, patch_size=4, width=32, layers=2, heads=4, embed_dim=16),
    text=TextConfig(vocab_size=64, context_length=8, width=32, layers=2, heads=4, embed_dim=16),
)
WORLD = 4
CLIP_NORM = 0.05    # below the first step's gradient norm: the clip scales
ADAMW = dict(warmup_steps=0, total_steps=100)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), as_tree(tree))


def _sgd(lr):
    """optax.sgd: the params move by -lr times the gradients."""
    return state.GradientTransformation(
        lambda params: (), lambda g, s, params=None: (tree_map(lambda x: -lr * x, g), s))


def _tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _keyed_leaves(*trees, path=""):
    """(path, the trees' leaves at it), walked by the first tree's keys."""
    if isinstance(trees[0], dict):
        for k in trees[0]:
            yield from _keyed_leaves(*(t[k] for t in trees), path=f"{path}/{k}")
    else:
        yield path, trees


def _tree_equal(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _gathered(x, line):
    """Every rank's x along the line, concatenated by line rank."""
    parts = [torch.empty_like(x) for _ in range(line.world)]
    dist.all_gather(parts, x.contiguous(), group=line.group)
    return torch.cat(parts)


# ---- what each spawned rank runs -------------------------------------------------------

def _layout_case(mesh, cfg, case):
    """The port's side of one layout's comparisons, on this rank's rows."""
    model, data = mesh.axis(MODEL_AXIS), mesh.axis(DATA_AXIS)
    rows = shard_batch(data, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    full = convert.to_params(case["params"], trainable=True)
    shard = sharding.shard_clip_params(mesh, full, cfg)
    out = {"coords": mesh.coords,
           "attn": _np(shard.tree()["vision"]["blocks"]["attn"]),
           "round_trip": all(torch.equal(a, b) for a, b in zip(
               tree_leaves(sharding.gather_clip_params(mesh, shard)), tree_leaves(full.tree())))}
    with torch.no_grad():
        p = shard.tree()
        img = _gathered(encode_image(p, cfg, rows["images"], normalize=True, tp=model), data)
        txt = _gathered(encode_text(p, cfg, rows["tokens"], normalize=True, tp=model), data)
        out["logits"] = (torch.exp(p["logit_scale"]) * img @ txt.T).numpy()

    def run(tx, steps):
        st = state.TrainState.create(sharding.shard_clip_params(mesh, full, cfg), tx)
        step = contrastive.make_gspmd_train_step(cfg, tx, mesh)
        losses = []
        for _ in range(steps):
            st, m = step(st, rows)
            losses.append(float(m["loss"]))
        return losses, _np(sharding.gather_clip_params(mesh, st.params))

    out["sgd"] = run(_sgd(1.0), 1)
    out["clip_sgd"] = run(state.chain(state.clip_by_global_norm(CLIP_NORM), _sgd(1.0)), 1)
    out["adamw_clip"] = run(state.make_adamw(1e-3, grad_clip=CLIP_NORM, **ADAMW), 2)
    grads = {}
    for remat in (False, True, "save_qkv"):
        _, _, g = contrastive.loss_and_grads(shard, cfg, rows["images"], rows["tokens"],
                                             dp=data, tp=model, remat=remat)
        grads[str(remat)] = _np(g)
    out["remat_equal"] = [_tree_equal(grads[k], grads["False"]) for k in ("True", "save_qkv")]
    return out


def _model_line_of_one(mesh, case):
    """One sgd(1.0) step of make_gspmd_train_step and one of make_train_step
    over the same data line, from the same params and rows."""
    data = mesh.axis(DATA_AXIS)
    rows = shard_batch(data, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    full = convert.to_params(case["params"], trainable=True)
    out = {"shape": dict(mesh.shape)}
    for name, params, make in (
            ("gspmd", sharding.shard_clip_params(mesh, full, CFG),
             lambda tx: contrastive.make_gspmd_train_step(CFG, tx, mesh)),
            ("dp", full, lambda tx: contrastive.make_train_step(CFG, tx, dp=data))):
        st, m = make(_sgd(1.0))(state.TrainState.create(params, _sgd(1.0)), rows)
        out[name] = (float(m["loss"]), _np(st.params))
    return out


def _tp_rank(mesh, cases):
    """TP(2) x DP(2) on the spawn's mesh, then TP(4) laid over the same world,
    then the default layout (every rank on "data", a model line of one)."""
    out = {"tp2": _layout_case(mesh, CFG, cases["tp2"]),
           "views": {k: (v.rank, v.world) for k, v in mesh.lines.items()},
           "line_ranks": mesh.line_ranks, "rank": mesh.rank}
    try:
        mesh.axis("pipe")
    except KeyError as err:
        out["missing"] = str(err)
    tp4 = create_mesh({DATA_AXIS: 1, MODEL_AXIS: WORLD}, device="cpu")
    out["tp4"] = _layout_case(tp4, CFG4, cases["tp4"])
    tp4.close()
    dp4 = create_mesh(None, device="cpu")
    out["model1"] = _model_line_of_one(dp4, cases["tp2"])
    dp4.close()
    return out


# ---- the mesh's layout --------------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import optax

    from construction_clip_tpu.core import configs as jconfigs
    from construction_clip_tpu.core import mesh as jmesh
    from construction_clip_tpu.models.clip import clip_forward, init_clip
    from construction_clip_tpu.parallel.sharding import shard_clip_params
    from construction_clip_tpu.train.contrastive import make_gspmd_train_step
    from construction_clip_tpu.train import state as jstate

    return types.SimpleNamespace(**locals())


@pytest.mark.parametrize("sizes", [{"data": 8}, {"data": 2, "model": 4}, {"pipe": 4, "data": 2},
                                   {"pipe": 2, "data": 2, "model": 2}, {"data": -1, "model": 2},
                                   None])
def test_rank_layout_is_jaxs_device_layout(jx, sizes):
    """Rank r sits where JAX's create_mesh puts device r (the row-major
    reshape of the device list), and a line along an axis is the ranks JAX's
    mesh holds along it, in the same order; -1 and None resolve alike."""
    jm = jx.jmesh.create_mesh(sizes)
    got = resolve_axis_sizes(sizes, 8)
    assert got == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert (ids == np.arange(8).reshape(ids.shape)).all()
    for i, name in enumerate(got):
        want = sorted(tuple(int(r) for r in line)
                      for line in np.moveaxis(ids, i, -1).reshape(-1, got[name]))
        assert sorted(tuple(line) for line in axis_lines(got, name)) == want


@pytest.mark.parametrize("sizes", [{"data": -1, "model": -1}, {"data": 3, "model": -1},
                                   {"data": 2, "model": 2}])
def test_mesh_refusals_match_jax(jx, sizes):
    """Two inferred axes, an axis that does not divide, and a product that is
    not the world: ValueError in both packages."""
    with pytest.raises(ValueError):
        jx.jmesh.create_mesh(sizes)
    with pytest.raises(ValueError):
        resolve_axis_sizes(sizes, 8)


# ---- the shard --------------------------------------------------------------------------

def test_param_specs_cover_tree(jx):
    """The spec tree has init_clip's structure, in the port and in JAX."""
    from jax.sharding import PartitionSpec as P

    is_spec = lambda x: isinstance(x, tuple)   # noqa: E731
    ported = jx.jax.tree.structure(sharding.clip_param_specs(), is_leaf=is_spec)
    assert ported == jx.jax.tree.structure(convert.init_clip(0, CFG))
    from construction_clip_tpu.parallel.sharding import clip_param_specs

    assert ported == jx.jax.tree.structure(clip_param_specs(),
                                           is_leaf=lambda x: isinstance(x, P))


def _stub_mesh(tp: int, rank: int = 0):
    line = types.SimpleNamespace(rank=rank, world=tp)
    return types.SimpleNamespace(axis=lambda name: line)


@pytest.mark.parametrize("tp,cfg", [(4, CFG), (3, CFG4), (8, CFG4)])
def test_tp_that_does_not_divide_the_heads_is_refused(tp, cfg):
    """JAX's test_tp_forward_matches_single_device runs TP(4) over 2 heads
    (GSPMD reshards around the head split); the port splits whole heads and
    refuses, naming both numbers."""
    tree = convert.to_params(convert.init_clip(0, cfg))
    with pytest.raises(ValueError, match=rf"over {tp} ranks .* {cfg.vision.heads} heads"):
        sharding.shard_clip_params(_stub_mesh(tp), tree, cfg)


def test_mlp_width_that_tp_does_not_divide_is_refused():
    """The MLP width's refusal names tp and the width."""
    tree = convert.init_clip(0, CFG4)
    for tower in ("vision", "text"):
        mlp = tree[tower]["blocks"]["mlp"]
        mlp["w_fc"], mlp["b_fc"] = mlp["w_fc"][..., :126], mlp["b_fc"][..., :126]
        mlp["w_proj"] = mlp["w_proj"][:, :126]
    with pytest.raises(ValueError, match=r"over 4 ranks .* MLP width 126"):
        sharding.shard_clip_params(_stub_mesh(4), convert.to_params(tree), CFG4)


# ---- 4 ranks against the JAX package -----------------------------------------------------

def _case(jx, cfg, seed):
    gen = np.random.default_rng(5)
    b = 8
    toks = np.zeros((b, 8), np.int32)
    toks[:, 0] = 62
    toks[:, 1:5] = gen.integers(1, 62, (b, 4))
    toks[:, 5] = 63   # EOT, the largest id: each row's features differ
    batch = {"images": gen.standard_normal((b, 16, 16, 3)).astype(np.float32), "tokens": toks}
    params = jx.jax.tree.map(lambda a: np.asarray(a, np.float32),
                             jx.init_clip(jx.jax.random.key(seed), _jcfg(jx, cfg)))
    return {"params": params, "batch": batch}


@pytest.fixture(scope="module")
def cases(jx):
    return {"tp2": _case(jx, CFG, 0), "tp4": _case(jx, CFG4, 1)}


@pytest.fixture(scope="module")
def ranks(cases):
    return spawn_ranks(_tp_rank, WORLD, (cases,), device="cpu", timeout=60,
                       axes={DATA_AXIS: 2, MODEL_AXIS: 2})


def _jcfg(jx, cfg):
    """The JAX package's config with the port's config's fields."""
    import dataclasses

    return jx.jconfigs.CLIPConfig(
        vision=jx.jconfigs.VisionConfig(**dataclasses.asdict(cfg.vision)),
        text=jx.jconfigs.TextConfig(**dataclasses.asdict(cfg.text)),
        quick_gelu=cfg.quick_gelu, logit_scale_init=cfg.logit_scale_init)


LAYOUTS = {"tp2": ({"data": 2, "model": 2}, CFG), "tp4": ({"data": 1, "model": 4}, CFG4)}


def _jax_mesh(jx, layout):
    sizes = LAYOUTS[layout][0]
    return jx.jmesh.create_mesh(sizes, devices=jx.jax.devices()[:WORLD])


def test_mesh_coordinates_and_lines(ranks):
    """Rank r sits at np.unravel_index(r, (2, 2)); its "data" view is its
    line (the ranks that share its model coordinate) with the line's rank
    and world, its "model" view likewise; an axis the mesh lacks is a
    KeyError naming it."""
    for rank in ranks:
        d, m = np.unravel_index(rank["rank"], (2, 2))
        assert rank["tp2"]["coords"] == {"data": d, "model": m}
        assert rank["views"] == {"data": (d, 2), "model": (m, 2)}
        assert rank["line_ranks"] == {"data": (m, 2 + m), "model": (2 * d, 2 * d + 1)}
        assert "'pipe'" in rank["missing"]


def test_shard_holds_the_ranks_heads_of_q_k_and_v(cases, ranks):
    """Rank r's w_qkv holds exactly heads [r H/tp, (r+1) H/tp) of q, of k and
    of v (b_qkv's rows likewise), and w_out the rows of those heads."""
    for layout, (sizes, cfg) in LAYOUTS.items():
        attn = cases[layout]["params"]["vision"]["blocks"]["attn"]
        d, tp = cfg.vision.width, sizes["model"]
        dh = d // cfg.vision.heads
        for rank in ranks:
            r = rank[layout]["coords"]["model"]
            heads = range(r * cfg.vision.heads // tp, (r + 1) * cfg.vision.heads // tp)
            cols = [part * d + h * dh + i for part in range(3) for h in heads for i in range(dh)]
            got = rank[layout]["attn"]
            np.testing.assert_array_equal(got["w_qkv"], attn["w_qkv"][..., cols])
            np.testing.assert_array_equal(got["b_qkv"], attn["b_qkv"][..., cols])
            rows = [h * dh + i for h in heads for i in range(dh)]
            np.testing.assert_array_equal(got["w_out"], attn["w_out"][:, rows])


def test_gather_of_the_shards_is_the_tree_bit_for_bit(ranks):
    """gather_clip_params(shard_clip_params(params)) is params, exactly."""
    assert all(rank[layout]["round_trip"] for rank in ranks for layout in LAYOUTS)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_forward_matches_jax(jx, cases, ranks, layout):
    """The towers' TP route (local heads, the partial products reduced over
    the model line) against JAX's clip_forward under the TP shardings on the
    same mesh: the logits per image at JAX's tolerance (rtol 2e-4, atol
    2e-5), on every rank."""
    cfg = _jcfg(jx, LAYOUTS[layout][1])
    mesh = _jax_mesh(jx, layout)
    params = jx.shard_clip_params(mesh, jx.jax.tree.map(jx.jnp.asarray, cases[layout]["params"]))
    batch = cases[layout]["batch"]
    want, _ = jx.jax.jit(lambda p, i, t: jx.clip_forward(p, cfg, i, t))(
        params, *jx.jmesh.shard_batch(mesh, (batch["images"], batch["tokens"])))
    for rank in ranks:
        np.testing.assert_allclose(rank[layout]["logits"], np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


_JAX_RUNS = {}


def _jax_steps(jx, layout, case, tx, steps, name):
    """JAX's GSPMD step on the layout's mesh, `steps` times (each run made
    once per test process, kept by name)."""
    if (layout, name) not in _JAX_RUNS:
        _JAX_RUNS[layout, name] = _run_jax_steps(jx, layout, case, tx, steps)
    return _JAX_RUNS[layout, name]


def _run_jax_steps(jx, layout, case, tx, steps):
    cfg = _jcfg(jx, LAYOUTS[layout][1])
    mesh = _jax_mesh(jx, layout)
    step = jx.make_gspmd_train_step(cfg, tx, mesh)
    st = jx.jstate.TrainState.create(
        jx.shard_clip_params(mesh, jx.jax.tree.map(jx.jnp.asarray, case["params"])), tx)
    losses = []
    for _ in range(steps):
        st, m = step(st, jx.jmesh.shard_batch(mesh, case["batch"]))
        losses.append(float(m["loss"]))
    return losses, jx.jax.tree.map(np.asarray, st.params)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_train_step_matches_jax(jx, cases, ranks, layout):
    """One sgd(1.0) step of make_gspmd_train_step (the params move by the
    gradient: the data line's mean of each shard's gradient) against JAX's
    GSPMD step on the same mesh, at JAX's tolerances (loss rtol 1e-5, params
    rtol 1e-3, atol 1e-5); every rank's gathered params the same."""
    losses, want = _jax_steps(jx, layout, cases[layout], jx.optax.sgd(1.0), 1, "sgd")
    for rank in ranks:
        np.testing.assert_allclose(rank[layout]["sgd"][0], losses, rtol=1e-5)
        _tree_close(rank[layout]["sgd"][1], want, rtol=1e-3, atol=1e-5)
        assert _tree_equal(rank[layout]["sgd"][1], ranks[0][layout]["sgd"][1])


def _moved(params, start):
    return jax_free_map(lambda p, s: np.asarray(p) - np.asarray(s), params, start)


def jax_free_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: jax_free_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grad_clip_takes_the_whole_trees_norm(jx, cases, ranks, layout):
    """clip_by_global_norm under the TP step sums the shards' squares over the
    model line and counts each replicated leaf once: clipped SGD, whose step
    is the clipped gradient (a norm of the rank's part alone would scale it
    otherwise), against JAX's optax.chain(clip_by_global_norm, sgd(1.0)):
    the steps at the sgd test's tolerances on the gradient (rtol 1e-3, atol
    1e-5), the atol scaled by the clip's factor, plus two ulps of the param
    (a step is read as the difference of two fp32 params), on every rank;
    the gradient's norm is above the clip, so the clip acts."""
    start = cases[layout]["params"]
    _, plain = _jax_steps(jx, layout, cases[layout], jx.optax.sgd(1.0), 1, "sgd")
    norm = np.sqrt(sum(float((d ** 2).sum()) for d in tree_leaves(_moved(plain, start))))
    assert norm > 2 * CLIP_NORM
    tx = jx.optax.chain(jx.optax.clip_by_global_norm(CLIP_NORM), jx.optax.sgd(1.0))
    losses, want = _jax_steps(jx, layout, cases[layout], tx, 1, "clip_sgd")
    atol = 1e-5 * CLIP_NORM / norm
    for rank in ranks:
        np.testing.assert_allclose(rank[layout]["clip_sgd"][0], losses, rtol=1e-5)
        for path, (got, w, s0) in _keyed_leaves(rank[layout]["clip_sgd"][1],
                                                jx.jax.tree.map(np.asarray, want), start):
            err = np.abs((got - s0) - (w - s0))
            bound = atol + 1e-3 * np.abs(w - s0) + 2 * np.spacing(np.abs(s0))
            assert (err <= bound).all(), (path, float((err - bound).max()))


def _noise_aware_close(got, want, grads, steps, lr, path=""):
    """Params to 2e-6 absolute, except elements whose first gradient lies
    below 1e-4 of its leaf's largest (as the mT5 step's test holds them):
    where fp32 rounding in sums of another order is a sizeable part of a
    gradient element, Adam normalises it into updates of up to lr a step of
    either sign, so the two sides may part by 2 lr a step. Returns (elements
    held to 2e-6, elements)."""
    if isinstance(want, dict):
        counts = [_noise_aware_close(got[k], want[k], grads[k], steps, lr, f"{path}/{k}")
                  for k in want]
        return tuple(map(sum, zip(*counts)))
    g = np.abs(grads)
    noise = g < 1e-4 * g.max()
    atol = np.where(noise, 2 * steps * lr, 2e-6)
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= atol).all(), (path, float(err.max()), float((err - atol).max()))
    return int((~noise).sum()), noise.size


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_adamw_with_grad_clip_matches_jax(jx, cases, ranks, layout):
    """make_adamw(grad_clip=...) over 2 steps against JAX's make_adamw with
    the same clip: the losses to 1e-5 relative and the params to 2e-6
    absolute, except where a gradient element is fp32 rounding noise
    (`_noise_aware_close`; the first gradient is the sgd step's move).
    AdamW's first update is about lr times the gradient's sign whatever the
    clip's scale, so the clipped-SGD test above is the one that holds the
    norm; this one holds make_adamw's chain, the training apps' optimizer."""
    tx = jx.jstate.make_adamw(1e-3, grad_clip=CLIP_NORM, **ADAMW)
    losses, want = _jax_steps(jx, layout, cases[layout], tx, 2, "adamw_clip")
    grads = _moved(cases[layout]["params"], ranks[0][layout]["sgd"][1])
    for rank in ranks:
        np.testing.assert_allclose(rank[layout]["adamw_clip"][0], losses, rtol=1e-5)
        held, total = _noise_aware_close(rank[layout]["adamw_clip"][1],
                                         jx.jax.tree.map(np.asarray, want), grads, 2, 1e-3)
        assert held >= 0.9 * total   # the allowance covers few elements


def test_model_line_of_one_rank_steps_as_data_parallel(ranks):
    """On create_mesh's default layout ({"data": 4, "model": 1}) nothing is
    split, so make_gspmd_train_step takes the one-device block route (K1 and
    K3 where they apply, as JAX's GSPMD step keeps its fused block) and its
    step is make_train_step's over the data line, bit for bit."""
    for rank in ranks:
        got = rank["model1"]
        assert got["shape"] == {"data": WORLD, "model": 1}
        assert got["gspmd"][0] == got["dp"][0]
        assert _tree_equal(got["gspmd"][1], got["dp"][1])


def test_remat_under_tp_is_bit_equal(ranks):
    """remat=True and a policy re-run their pieces' all-reduces in the
    backward on every rank in the same order: the gradients are no remat's,
    bit for bit, at both layouts."""
    assert all(rank[layout]["remat_equal"] == [True, True] for rank in ranks
               for layout in LAYOUTS)
