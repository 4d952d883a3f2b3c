"""PyTorch port, pipeline parallelism against the JAX package: the GPipe
schedule over the "pipe" line (parallel/pipeline.py) against JAX's on the
same meshes of conftest's virtual devices: the raw block pipeline at
PP(4) x DP(2) against gpt2_forward's layer scan, clipcap_forward_pp against
clipcap_forward and JAX's clipcap_forward_pp, one full fine-tune sgd(1.0)
step of make_caption_train_step_pp at PP(4) x DP(2) and PP(2) x DP(2) x
model(2) against JAX's (the params move by the gradient: the last stage's
cotangent entering the reverse schedule once, the tied wte's two parts, the
global token mean over data ranks of uneven padding), a gradient clip over
the stages, remat, and JAX's divisibility refusals.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous): one spawn of 8 ranks runs every case, the second layout laid
over the same world. This module imports no JAX at its top."""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.mesh import (
    DATA_AXIS, MODEL_AXIS, create_mesh, shard_batch, spawn_ranks)
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.models import gpt2
from construction_clip_tpu_torch.models.clipcap.model import (
    caption_loss, clipcap_forward_pp)
from construction_clip_tpu_torch.ops.norms import layer_norm
from construction_clip_tpu_torch.parallel.pipeline import PIPE_AXIS, pipelined_blocks
from construction_clip_tpu_torch.train import caption, state

GCFG = GPT2Config(vocab_size=96, n_positions=64, n_embd=32, n_layer=4, n_head=2)
CCFG = ClipCapConfig(prefix_length=3, attribute_length=2, clip_dim=16, only_prefix=False)
WORLD = 8
LAYOUTS = {"pp4_dp2": ({PIPE_AXIS: 4, DATA_AXIS: 2}, 4),
           "pp2_dp2_model2": ({PIPE_AXIS: 2, DATA_AXIS: 2, MODEL_AXIS: 2}, 2)}
CLIP_NORM = 0.5


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), as_tree(tree))


def _gathered(x, line):
    """Every rank's x along the line, concatenated by line rank."""
    parts = [torch.empty_like(x) for _ in range(line.world)]
    dist.all_gather(parts, x.contiguous(), group=line.group)
    return torch.cat(parts)


def _sgd(lr):
    """optax.sgd: the params move by -lr times the gradients."""
    return state.GradientTransformation(
        lambda params: (), lambda g, s, params=None: (tree_map(lambda x: -lr * x, g), s))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- what each spawned rank runs -------------------------------------------------------

def _step(mesh, case, micro, tx, remat=False):
    params = caption.shard_clipcap_params_pp(
        mesh, convert.to_params(case["params"], trainable=True))
    st = state.TrainState.create(params, tx)
    rows = shard_batch(mesh.axis(DATA_AXIS), _torch(case["batch"]))
    st, m = caption.make_caption_train_step_pp(CCFG, GCFG, tx, mesh, microbatches=micro,
                                               remat=remat)(st, rows)
    return float(m["loss"]), _np(st.params)


def _forward_cases(mesh, case):
    """PP(4) x DP(2): the raw blocks, the ClipCap forward, remat's gradients."""
    data = mesh.axis(DATA_AXIS)
    out = {}
    gpt = convert.to_params(case["gpt"])
    stage = caption.shard_clipcap_params_pp(mesh, {"gpt": gpt.tree()})["gpt"]
    x = shard_batch(data, {"x": torch.from_numpy(case["x"])})["x"]
    with torch.no_grad():
        h = x + stage["wpe"][:x.shape[1]]
        h = pipelined_blocks(stage["blocks"], h, None, GCFG, mesh, microbatches=4)
        h = layer_norm(h, stage["ln_f"]["scale"], stage["ln_f"]["bias"],
                       eps=GCFG.layer_norm_epsilon)
        out["blocks_logits"] = _gathered(gpt2._lm_logits(stage, h), data).numpy()

    params = caption.shard_clipcap_params_pp(mesh, convert.to_params(case["params"],
                                                                     trainable=True))
    rows = shard_batch(data, _torch(case["batch"]))

    def logits(remat):
        return clipcap_forward_pp(as_tree(params), CCFG, GCFG, tokens=rows["tokens"],
                                  clip_embed=rows["prefix"], attribute_tokens=rows["attribute"],
                                  mesh=mesh, microbatches=4, remat=remat, dp_axis=DATA_AXIS)

    with torch.no_grad():
        out["clipcap_logits"] = _gathered(logits(False), data).numpy()
    grads = {}
    for remat in (False, True):
        loss = caption_loss(logits(remat), rows["tokens"], CCFG)
        g = torch.autograd.grad(loss, tree_leaves(as_tree(params)))
        grads[remat] = [t.numpy() for t in g]
    out["remat_equal"] = all(np.array_equal(a, b) for a, b in zip(grads[False], grads[True]))
    return out


def _pp_rank(mesh, case):
    out = {"coords": mesh.coords, "forward": _forward_cases(mesh, case), "layouts": {}}
    for name, (axes, micro) in LAYOUTS.items():
        layout = mesh if axes == dict(mesh.shape) else create_mesh(axes, device="cpu")
        out["layouts"][name] = {
            "coords": layout.coords,
            "sgd": _step(layout, case, micro, _sgd(1.0)),
            "sgd_remat": _step(layout, case, micro, _sgd(1.0), remat=True),
            "clip_sgd": _step(layout, case, micro,
                              state.chain(state.clip_by_global_norm(CLIP_NORM), _sgd(1.0)))}
        if layout is not mesh:
            layout.close()
    return out


# ---- against the JAX package --------------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import optax

    from construction_clip_tpu.core import configs as jconfigs
    from construction_clip_tpu.core import mesh as jmesh
    from construction_clip_tpu.models import gpt2 as jgpt2
    from construction_clip_tpu.models.clipcap import init_clipcap
    from construction_clip_tpu.models.clipcap.model import clipcap_forward
    from construction_clip_tpu.models.clipcap.model import clipcap_forward_pp as jforward_pp
    from construction_clip_tpu.parallel import pipeline as jpipeline
    from construction_clip_tpu.train import caption as jcaption
    from construction_clip_tpu.train import state as jstate

    gcfg = jconfigs.GPT2Config(**dataclasses.asdict(GCFG))
    ccfg = jconfigs.ClipCapConfig(**dataclasses.asdict(CCFG))
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def case(jx):
    rng = np.random.default_rng(7)
    b, t = 8, 6
    toks = rng.integers(1, 96, (b, t)).astype(np.int32)
    toks[:4, -3:] = 0   # ignore_id padding, uneven over the two data ranks
    toks[4:, -1:] = 0
    batch = {"tokens": toks, "prefix": rng.standard_normal((b, 16)).astype(np.float32),
             "attribute": rng.integers(1, 96, (b, 2)).astype(np.int32)}
    to_np = lambda tree: jx.jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
    return {"batch": batch,
            "params": to_np(jx.init_clipcap(jx.jax.random.key(2), jx.ccfg, jx.gcfg)),
            "gpt": to_np(jx.jgpt2.init_gpt2(jx.jax.random.key(0), jx.gcfg)),
            "x": np.random.default_rng(1).standard_normal((8, 6, 32)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(case):
    axes = LAYOUTS["pp4_dp2"][0]
    return spawn_ranks(_pp_rank, WORLD, (case,), device="cpu", timeout=60, axes=axes)


def test_pipelined_blocks_match_scan(jx, case, ranks):
    """The raw block pipeline at PP(4) x DP(2), 4 microbatches, composed with
    the head as gpt2_forward composes it: the logits of JAX's single-device
    layer scan on the same stacked params (JAX's tolerance, 2e-5), on every
    rank."""
    ref, _ = jx.jgpt2.gpt2_forward(jx.jax.tree.map(jx.jnp.asarray, case["gpt"]), jx.gcfg,
                                   inputs_embeds=case["x"])
    for rank in ranks:
        np.testing.assert_allclose(rank["forward"]["blocks_logits"], np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_pp_forward_matches_clipcap(jx, case, ranks):
    """clipcap_forward_pp at PP(4) x DP(2) against JAX's clipcap_forward and
    JAX's clipcap_forward_pp on the same mesh (2e-5)."""
    params = jx.jax.tree.map(jx.jnp.asarray, case["params"])
    b = case["batch"]
    ref = jx.clipcap_forward(params, jx.ccfg, jx.gcfg, tokens=b["tokens"],
                             clip_embed=b["prefix"], attribute_tokens=b["attribute"])
    mesh = jx.jmesh.create_mesh(LAYOUTS["pp4_dp2"][0])
    pp = jx.jax.jit(lambda p, b: jx.jforward_pp(
        p, jx.ccfg, jx.gcfg, tokens=b["tokens"], clip_embed=b["prefix"],
        attribute_tokens=b["attribute"], mesh=mesh, microbatches=4))(
            jx.jcaption.shard_clipcap_params_pp(mesh, params), b)
    for rank in ranks:
        for want in (ref, pp):
            np.testing.assert_allclose(rank["forward"]["clipcap_logits"], np.asarray(want),
                                       rtol=2e-5, atol=2e-5)


_JAX_STEPS = {}


def _jax_step(jx, case, layout, name, tx):
    """JAX's make_caption_train_step_pp on the layout's mesh, one step."""
    if (layout, name) not in _JAX_STEPS:
        axes, micro = LAYOUTS[layout]
        mesh = jx.jmesh.create_mesh(axes)
        params = jx.jcaption.shard_clipcap_params_pp(
            mesh, jx.jax.tree.map(jx.jnp.asarray, case["params"]))
        st = jx.jstate.TrainState.create(params, tx)
        step = jx.jcaption.make_caption_train_step_pp(jx.ccfg, jx.gcfg, tx, mesh,
                                                      microbatches=micro)
        st, m = step(st, jx.jax.tree.map(jx.jnp.asarray, case["batch"]))
        _JAX_STEPS[layout, name] = float(m["loss"]), jx.jax.tree.map(np.asarray, st.params)
    return _JAX_STEPS[layout, name]


def _stage_close(got, want, stage, stages, rtol, atol, path=""):
    """A stage's tree against the full one: the block stack's leaves against
    the stage's layers, the rest whole."""
    if isinstance(want, dict):
        for k in want:
            _stage_close(got[k], want[k], stage, stages, rtol, atol, f"{path}/{k}")
        return
    if "/blocks/" in path:
        n = want.shape[0] // stages
        want = want[stage * n:(stage + 1) * n]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("run", ["sgd", "sgd_remat"])
def test_pp_train_step_matches_jax(jx, case, ranks, layout, run):
    """One full fine-tune step (sgd(1.0): the params move by the gradient)
    against JAX's make_caption_train_step_pp on the same mesh: the loss
    (rtol 1e-5, atol 1e-6) and every stage's params, the replicated leaves
    (the mapper, wpe, the tied wte) on every stage, at JAX's tolerance
    (3e-5); with remat too."""
    loss, want = _jax_step(jx, case, layout, "sgd", jx.optax.sgd(1.0))
    stages = LAYOUTS[layout][0][PIPE_AXIS]
    for rank in ranks:
        got_loss, got = rank["layouts"][layout][run]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5, atol=1e-6)
        _stage_close(got, want, rank["layouts"][layout]["coords"][PIPE_AXIS], stages,
                     rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grad_clip_takes_the_norm_over_the_stages(jx, case, ranks, layout):
    """clip_by_global_norm in the PP step sums the stages' squares over the
    pipe line and counts each replicated leaf once: clipped SGD against JAX's
    optax.chain(clip_by_global_norm, sgd(1.0)); the clip acts (the moves
    differ from the plain sgd step's) and each stage's move is JAX's within
    3e-5 of the param (JAX's step tolerance)."""
    tx = jx.optax.chain(jx.optax.clip_by_global_norm(CLIP_NORM), jx.optax.sgd(1.0))
    loss, want = _jax_step(jx, case, layout, "clip_sgd", tx)
    _, plain = _jax_step(jx, case, layout, "sgd", jx.optax.sgd(1.0))
    start = case["params"]
    plain_norm = np.sqrt(sum(float(((np.asarray(a) - b) ** 2).sum()) for a, b in zip(
        jx.jax.tree.leaves(plain), jx.jax.tree.leaves(start))))
    assert plain_norm > 2 * CLIP_NORM
    stages = LAYOUTS[layout][0][PIPE_AXIS]
    for rank in ranks:
        got_loss, got = rank["layouts"][layout]["clip_sgd"]
        np.testing.assert_allclose(got_loss, loss, rtol=1e-5, atol=1e-6)
        _stage_close(got, want, rank["layouts"][layout]["coords"][PIPE_AXIS], stages,
                     rtol=3e-5, atol=3e-5)


def test_replicated_leaves_agree_on_every_stage(ranks):
    """The mapper, wpe, ln_f and the tied wte (its embedding part from stage
    0, its head part from the last stage) after the step: the same bits on
    every rank of every layout."""
    for layout in LAYOUTS:
        first = ranks[0]["layouts"][layout]["sgd"][1]
        for rank in ranks[1:]:
            got = rank["layouts"][layout]["sgd"][1]
            for a, b in zip(tree_leaves(got["mapper"]), tree_leaves(first["mapper"])):
                assert np.array_equal(a, b)
            for k in ("wte", "wpe"):
                assert np.array_equal(got["gpt"][k], first["gpt"][k])


def test_pp_remat_gradients_are_bit_equal(ranks):
    """Checkpointing each layer of each stage re-runs the same ops on the same
    bits: remat's gradients are no remat's, exactly (JAX's test holds them to
    1e-5), on every rank."""
    assert all(rank["forward"]["remat_equal"] for rank in ranks)


def _stub_mesh(world):
    line = types.SimpleNamespace(rank=0, world=world)
    return types.SimpleNamespace(axis=lambda name: line)


def test_divisibility_refusals_match_jax(jx, case):
    """JAX's two ValueErrors, word for word: a batch the microbatches do not
    divide, and layers the pipe line does not divide."""
    gpt = convert.to_params(case["gpt"]).tree()
    x = torch.zeros(6, 6, 32)
    with pytest.raises(ValueError) as ours:
        pipelined_blocks(gpt["blocks"], x, None, GCFG, _stub_mesh(4), microbatches=4)
    mesh = jx.jmesh.create_mesh({PIPE_AXIS: 4, DATA_AXIS: 2})
    with pytest.raises(ValueError) as theirs:
        jx.jpipeline.pipelined_blocks(jx.jax.tree.map(jx.jnp.asarray, case["gpt"]["blocks"]),
                                      jx.jnp.zeros((6, 6, 32)), None, jx.gcfg, mesh,
                                      microbatches=4)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        caption.shard_clipcap_params_pp(_stub_mesh(8), {"gpt": gpt})
    mesh = jx.jmesh.create_mesh({PIPE_AXIS: 8})
    with pytest.raises(ValueError) as theirs:
        jx.jpipeline.pipelined_blocks(jx.jax.tree.map(jx.jnp.asarray, case["gpt"]["blocks"]),
                                      jx.jnp.zeros((8, 6, 32)), None, jx.gcfg, mesh,
                                      microbatches=4)
    assert str(ours.value) == str(theirs.value)
