"""PyTorch port, ClipCap caption training against the JAX package (CPU): the
training forward and its loss, 3 steps of make_caption_train_step in both
modes, the 2-rank data-parallel step against one process, GPT-2's stacked
layers under autograd, ArrayLoader's batches and the caption tokenisation,
and the train_clipcap app.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous, at most 60 s a group). Each imports this module, which imports
no JAX at its top: the tests take it from the `jx` fixture."""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.mesh import shard_batch, spawn_ranks
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
from construction_clip_tpu_torch.data.loader import TorchArrayLoader
from construction_clip_tpu_torch.data.pipeline import ArrayLoader
from construction_clip_tpu_torch.models.clipcap import model
from construction_clip_tpu_torch.train import caption, state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCFG = GPT2Config.tiny()
CCFG = ClipCapConfig(prefix_length=4, attribute_length=3, clip_dim=16)
B, T = 4, 8
LR = 1e-4


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.core import configs as jconfigs
    from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
    from construction_clip_tpu.core.precision import BF16_POLICY as JBF16
    from construction_clip_tpu.models.clipcap import model as jmodel
    from construction_clip_tpu.train import caption as jcaption
    from construction_clip_tpu.train import state as jstate

    jgcfg = jconfigs.GPT2Config.tiny()
    mesh = create_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, devices=jax.devices()[:1])
    return types.SimpleNamespace(**locals())


def _jccfg(jx, ccfg):
    return jx.jconfigs.ClipCapConfig(**dataclasses.asdict(ccfg))


def _np(tree):
    return tree_map(lambda t: np.asarray(t, np.float32).copy()
                    if not isinstance(t, torch.Tensor) else t.detach().float().numpy().copy(),
                    tree)


@pytest.fixture(scope="module")
def jparams(jx):
    """The JAX package's init, as numpy."""
    tree = jx.jmodel.init_clipcap(jx.jax.random.key(3), _jccfg(jx, CCFG), jx.jgcfg)
    return jx.jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(seed, b=B, t=T):
    """Captions of uneven length, zero-padded (one row of a single token)."""
    gen = np.random.default_rng(seed)
    tokens = gen.integers(1, GCFG.vocab_size, (b, t)).astype(np.int32)
    for i, n in enumerate([t, 5, 1, 3, 7, 2, 6, 4][:b]):
        tokens[i, n:] = 0
    return {"tokens": tokens,
            "prefix": gen.standard_normal((b, CCFG.clip_dim)).astype(np.float32),
            "attribute": gen.integers(1, GCFG.vocab_size, (b, CCFG.attribute_length)
                                      ).astype(np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---- forward and loss --------------------------------------------------------------------

# (rtol, atol) of the logits against JAX's op by op: fp32 by summation order in
# a 2-layer model (logits ~0.5); bf16 by single roundings of an activation that
# another order of the fp32 sums can flip (one bf16 step is 2^-8 relative)
FORWARD_TOL = {"fp32": (1e-6, 1e-6), "bf16": (2e-2, 2e-2)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_and_loss_match_jax(precision, jx, jparams):
    """clipcap_forward's logits and caption_loss(_parts) on rows of uneven
    padding, against the JAX package evaluated op by op (jax.disable_jit(): a
    jitted XLA program fuses bf16 chains and skips their roundings)."""
    batch = _batch(0)
    kw = {} if precision == "fp32" else {"policy": jx.JBF16}
    with jx.jax.disable_jit():
        want = jx.jmodel.clipcap_forward(
            jparams, _jccfg(jx, CCFG), jx.jgcfg, tokens=jx.jnp.asarray(batch["tokens"]),
            clip_embed=jx.jnp.asarray(batch["prefix"]),
            attribute_tokens=jx.jnp.asarray(batch["attribute"]), **kw)
        want_parts = jx.jmodel.caption_loss_parts(want, jx.jnp.asarray(batch["tokens"]),
                                                  _jccfg(jx, CCFG))
        want_loss = jx.jmodel.caption_loss(want, jx.jnp.asarray(batch["tokens"]),
                                           _jccfg(jx, CCFG))
    tb = _torch(batch)
    got = model.clipcap_forward(convert.to_params(jparams).tree(), CCFG, GCFG,
                                tokens=tb["tokens"], clip_embed=tb["prefix"],
                                attribute_tokens=tb["attribute"],
                                policy=BF16_POLICY if precision == "bf16" else DEFAULT_POLICY)
    assert got.dtype == torch.float32 and got.shape == (B, 4 + 3 + T, GCFG.vocab_size)
    rtol, atol = FORWARD_TOL[precision]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    total, count = model.caption_loss_parts(got, tb["tokens"], CCFG)
    assert float(count) == float(want_parts[1]) == 8 + 5 + 1 + 3
    np.testing.assert_allclose(float(total), float(want_parts[0]), rtol=10 * rtol)
    np.testing.assert_allclose(float(model.caption_loss(got, tb["tokens"], CCFG)),
                               float(want_loss), rtol=10 * rtol)


def test_loss_ignores_padding_and_counts_nothing_of_an_empty_batch():
    logits = torch.randn(2, 4 + 3 + 3, GCFG.vocab_size)
    tokens = torch.tensor([[5, 0, 0], [7, 9, 0]])
    total, count = model.caption_loss_parts(logits, tokens, CCFG)
    logp = torch.log_softmax(logits[:, 6:-1], dim=-1)
    want = -(logp[0, 0, 5] + logp[1, 0, 7] + logp[1, 1, 9])
    assert float(count) == 3
    torch.testing.assert_close(total, want)
    empty = torch.zeros_like(tokens)
    assert float(model.caption_loss(logits, empty, CCFG)) == 0.0


def test_stacked_gpt2_leaves_take_their_gradients_through_one_unbind(jparams):
    """Every stacked GPT-2 leaf of a full fine-tune reaches its gradient through
    one unbind, whose backward stacks the L layer gradients, and no per-layer
    select (each of which would fill a zeroed copy of the whole stack)."""
    params = convert.to_params(jparams, trainable=True)
    tb = _torch(_batch(1))
    loss = model.caption_loss(model.clipcap_forward(
        params.tree(), CCFG, GCFG, tokens=tb["tokens"], clip_embed=tb["prefix"],
        attribute_tokens=tb["attribute"]), tb["tokens"], CCFG)
    stacked = {id(p) for p in tree_leaves(params.tree()["gpt"]["blocks"])}
    parents, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            if child is not None and hasattr(child, "variable") and id(child.variable) in stacked:
                parents.setdefault(id(child.variable), []).append(type(node).__name__)
            todo.append(child)
    assert len(parents) == len(stacked)
    assert all(names == ["UnbindBackward0"] for names in parents.values()), parents


# ---- three train steps against JAX ---------------------------------------------------------

@pytest.mark.parametrize("only_prefix", [True, False], ids=["only_prefix", "full"])
def test_train_steps_match_jax(only_prefix, jx, jparams):
    """3 steps from the same params and batches against the JAX package's
    make_caption_train_step on a 1-device mesh, fp32. Loss to 1e-5 relative
    each step; the trainable params after step 3 to 2e-6 absolute: AdamW moves
    a weight by at most about lr = 1e-4 a step, carrying the gradient's
    relative error (~1e-6). The exception is the key third of GPT-2's c_attn_b
    (full fine-tune): its gradient is mathematically zero (softmax does not
    change when every logit of a row moves by q.b_k), so both sides normalise
    rounding noise of either sign into updates of up to lr, and they may move
    apart by 2 lr a step; it is held only to that bound. In only-prefix mode
    the frozen GPT-2 stays bit-equal to its start."""
    _steps_match_jax(jx, dataclasses.replace(CCFG, only_prefix=only_prefix), jparams)


def _steps_match_jax(jx, ccfg, jparams):
    jccfg = _jccfg(jx, ccfg)
    kw = dict(warmup_steps=0, total_steps=100)
    jtx, ttx = jx.jstate.make_adamw(LR, **kw), state.make_adamw(LR, **kw)
    jstep = jx.jcaption.make_caption_train_step(jccfg, jx.jgcfg, jtx, jx.mesh)
    tstep = caption.make_caption_train_step(ccfg, GCFG, ttx)
    jtree = jx.jax.tree.map(jx.jnp.asarray, jparams)
    if ccfg.only_prefix:
        jst, jfrozen = jx.jstate.TrainState.create(jtree["mapper"], jtx), jtree["gpt"]
        gpt = convert.to_params(jparams["gpt"]).tree()
        tst = state.TrainState.create(convert.to_params(jparams["mapper"], trainable=True), ttx)
    else:
        jst, jfrozen, gpt = jx.jstate.TrainState.create(jtree, jtx), None, None
        tst = state.TrainState.create(convert.to_params(jparams, trainable=True), ttx)
    for i in range(3):
        batch = _batch(10 + i)
        jst, jm = jstep(jst, jfrozen, {k: jx.jnp.asarray(v) for k, v in batch.items()})
        tst, tm = tstep(tst, gpt, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = _np(as_tree(tst.params)), _np(jst.params)
    _tree_close(got, want, atol=2e-6, key_bias_atol=2 * 3 * LR)
    assert tst.step == int(jst.step) == 3
    assert len(tree_leaves(tst.opt_state["m"])) == len(jx.jax.tree.leaves(want))
    if ccfg.only_prefix:
        _tree_close(_np(gpt), jparams["gpt"], atol=0)


def _tree_close(got, want, atol, key_bias_atol=None, path=""):
    """Every leaf within `atol`; the key third of an attention bias (GPT-2's
    c_attn_b, a mapper block's b_qkv: a gradient that is rounding noise)
    within `key_bias_atol` where one is given."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_close(got[k], want[k], atol, key_bias_atol, f"{path}/{k}")
        return
    if key_bias_atol is not None and path.endswith(("/attn/c_attn_b", "/attn/b_qkv")):
        d = want.shape[-1] // 3
        np.testing.assert_allclose(got[..., d:2 * d], want[..., d:2 * d], rtol=0,
                                   atol=key_bias_atol, err_msg=path)
        got, want = np.delete(got, np.s_[d:2 * d], -1), np.delete(want, np.s_[d:2 * d], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)


def test_bf16_step_trains_fp32_masters(jparams):
    """Under the bf16 policy the params and AdamW's moments stay fp32, the
    frozen GPT-2 cast once before the steps is used as it is, and the loss
    falls over 3 steps on one batch."""
    ttx = state.make_adamw(1e-3, warmup_steps=0, total_steps=100)
    step = caption.make_caption_train_step(CCFG, GCFG, ttx, policy=BF16_POLICY)
    gpt = BF16_POLICY.cast_to_compute(convert.to_params(jparams["gpt"]).tree())
    tst = state.TrainState.create(convert.to_params(jparams["mapper"], trainable=True), ttx)
    batch = _torch(_batch(3))
    losses = []
    for _ in range(3):
        tst, m = step(tst, gpt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in tree_leaves(as_tree(tst.params)))
    assert all(v.dtype == torch.float32 for v in tree_leaves(tst.opt_state["v"]))
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree_leaves(gpt))


# ---- two ranks against one process ---------------------------------------------------------

def _sgd(lr):
    """optax.sgd: linear in the gradients, so that the summed gradients of the
    ranks are held to the one-process step without AdamW's normalisation."""
    return state.GradientTransformation(
        lambda params: (), lambda g, s, params=None: (tree_map(lambda x: -lr * x, g), s))


def _dp_case_rank(dp, case):
    """The port's DP step on this rank's rows: loss and gradients, then one
    SGD step (only-prefix) and one AdamW step (full fine-tune)."""
    rows = shard_batch(dp, _torch(case["batch"]))
    frozen = convert.to_params(case["params"]["gpt"]).tree()
    mapper = convert.to_params(case["params"]["mapper"], trainable=True)
    loss, grads = caption.loss_and_grads(mapper, frozen, CCFG, GCFG, rows, dp=dp)
    out = {"loss": float(loss), "grads": _np(grads)}
    st = state.TrainState.create(mapper, _sgd(0.1))
    st, m = caption.make_caption_train_step(CCFG, GCFG, _sgd(0.1), dp=dp)(st, frozen, rows)
    out["sgd"] = (float(m["loss"]), _np(as_tree(st.params)))
    full = dataclasses.replace(CCFG, only_prefix=False)
    tx = state.make_adamw(LR, warmup_steps=0, total_steps=100)
    st = state.TrainState.create(convert.to_params(case["params"], trainable=True), tx)
    st, m = caption.make_caption_train_step(full, GCFG, tx, dp=dp)(st, None, rows)
    out["adamw"] = (float(m["loss"]), _np(as_tree(st.params)))
    return out


def test_two_ranks_with_uneven_padding_equal_one_process(jparams):
    """2 gloo ranks whose rows carry different amounts of padding (rank 0's
    rows 8 and 5 valid tokens, rank 1's 1 and 3) against the one-process step
    on the global batch: the loss (the global token mean, not the mean of the
    ranks' means) and every summed gradient leaf to 1e-5 relative; one SGD
    step's params to 1e-6; one AdamW full fine-tune step's params to 2e-6,
    c_attn_b's key third to 2 lr (its gradient is rounding noise, as in
    test_train_steps_match_jax)."""
    case = {"batch": _batch(5), "params": jparams}
    ranks = spawn_ranks(_dp_case_rank, 2, (case,), device="cpu", timeout=60)
    one = _dp_case_rank(types.SimpleNamespace(rank=0, world=1, device=torch.device("cpu")),
                        case)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=1e-5)
        for a, b in zip(tree_leaves(r["grads"]), tree_leaves(one["grads"])):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * float(np.abs(b).max()))
        np.testing.assert_allclose(r["sgd"][0], one["sgd"][0], rtol=1e-5)
        _tree_close(r["sgd"][1], one["sgd"][1], atol=1e-6)
        np.testing.assert_allclose(r["adamw"][0], one["adamw"][0], rtol=1e-5)
        _tree_close(r["adamw"][1], one["adamw"][1], atol=2e-6, key_bias_atol=2 * LR)


# ---- the loader ----------------------------------------------------------------------------

def _arrays(n):
    gen = np.random.default_rng(2)
    return {"prefix": gen.standard_normal((n, 5)).astype(np.float32),
            "tokens": gen.integers(0, 50, (n, 6)).astype(np.int32),
            "attribute": gen.integers(0, 50, (n, 3)).astype(np.int32)}


@pytest.mark.parametrize("world", [1, 2])
def test_torch_array_loader_shards_make_the_global_batch(world):
    """Each rank yields its rows of every global batch as tensors on its
    device; in rank order they are the host loader's batch, for two epochs."""
    arrays = _arrays(13)
    whole = ArrayLoader(arrays, batch_size=4)
    ranks = [TorchArrayLoader(arrays, batch_size=4, dp=types.SimpleNamespace(
        rank=r, world=world, device=torch.device("cpu"))) for r in range(world)]
    for _ in range(2):
        want = list(whole)
        shards = [list(loader) for loader in ranks]
        assert all(len(s) == len(want) == 3 for s in shards)
        for i, batch in enumerate(want):
            for k, v in batch.items():
                assert all(s[i][k].shape[0] == 4 // world for s in shards)
                np.testing.assert_array_equal(torch.cat([s[i][k] for s in shards]).numpy(), v)
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        TorchArrayLoader(arrays, batch_size=4, dp=types.SimpleNamespace(
            rank=0, world=3, device=torch.device("cpu")))


def _vocab(tmp_path, size=21128):
    from construction_clip_tpu_torch.data.offline_assets import (
        corpus_characters, write_bert_vocab)

    path = str(tmp_path / "vocab.txt")
    write_bert_vocab(path, corpus_characters([]), size=size)
    return path


# ---- the app -------------------------------------------------------------------------------

def _archive(path, n=10, dim=16):
    gen = np.random.default_rng(4)
    chars = "工地墜落邊緣開口機械物料"
    caps = ["".join(gen.choice(list(chars), size=int(k))) for k in gen.integers(2, 9, n)]
    np.savez(path, embeddings=gen.standard_normal((n, dim)).astype(np.float32),
             attributes=np.asarray(["缺失 墜落 "] * n, dtype=object),
             captions=np.asarray(caps, dtype=object))


def test_app_trains_only_the_prefix_resumes_and_writes_npz(tmp_path, capsys, monkeypatch, jx):
    """train_clipcap --only_prefix on the CPU: one epoch, then two resuming
    from the first's checkpoint; the npz carries the mapper it trained and
    GPT-2 as initialised, and loads into the JAX package at its shapes."""
    from construction_clip_tpu_torch.apps import train_clipcap
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    _archive(tmp_path / "emb.npz")
    argv = ["--data", str(tmp_path / "emb.npz"), "--out_dir", str(tmp_path / "m"),
            "--prefix", "cap", "--save_every", "1", "--bs", "4", "--lr", "1e-3",
            "--warmup_steps", "0", "--gpt_size", "tiny", "--tokenizer", _vocab(tmp_path, 128),
            "--log_dir", str(tmp_path / "log"), "--device", "cpu", "--precision", "fp32",
            "--only_prefix", "--prefix_length", "4", "--attribute_length", "6"]
    train_clipcap.main(argv + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "Train only prefix" in out and "saved inference params" in out
    train_clipcap.main(argv + ["--epochs", "2"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "m" / "cap")) == ["step_0.pt", "step_1.pt", "step_2.pt"]
    logs = [json.loads(line) for line in open(tmp_path / "log" / "cap.jsonl")]
    assert [r["step"] for r in logs] == [2, 4]   # 10 items, 4 a step, 2 epochs
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=6, clip_dim=16)
    saved = load_params_npz(str(tmp_path / "m" / "cap.npz"),
                            convert.init_clipcap(convert.SHAPES, ccfg, GCFG))
    init = convert.init_clipcap(train_clipcap.INIT_SEED, ccfg, GCFG)
    _tree_close(saved["gpt"], init["gpt"], atol=0)
    assert not np.array_equal(saved["mapper"]["w2"], init["mapper"]["w2"])
    template = jx.jmodel.init_clipcap(jx.jax.random.key(0), _jccfg(jx, ccfg), jx.jgcfg)
    from construction_clip_tpu.train.checkpoint import load_params_npz as jload

    jloaded = jload(str(tmp_path / "m" / "cap.npz"), template)
    _tree_close(_np(jloaded), saved, atol=0)


def test_app_names_the_cause_of_an_epoch_without_steps(tmp_path, monkeypatch):
    from construction_clip_tpu_torch.apps import train_clipcap

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    _archive(tmp_path / "emb.npz", n=3)
    argv = ["--data", str(tmp_path / "emb.npz"), "--out_dir", str(tmp_path / "m"),
            "--bs", "4", "--epochs", "1", "--gpt_size", "tiny", "--device", "cpu",
            "--tokenizer", _vocab(tmp_path, 128), "--log_dir", str(tmp_path / "log")]
    with pytest.raises(RuntimeError, match="global batch 4 x 1 ranks > 3 archive items"):
        train_clipcap.main(argv)


# ---- the transformer mapper ----------------------------------------------------------------

# 2 mapper blocks over 3 projected rows and the 4-row prefix constant, 8 heads
# of GPT2Config.tiny's width 32 (dh 4)
TCCFG = dataclasses.replace(CCFG, mapper="transformer", mapper_layers=2, clip_length=3)
# (rtol, atol) of the prefix against JAX's op by op: fp32 by summation order; bf16
# by single roundings that another order can flip (one bf16 step is 2^-8)
MAPPER_TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 2e-2)}


@pytest.fixture(scope="module")
def jparams_transformer(jx):
    tree = jx.jmodel.init_clipcap(jx.jax.random.key(4), _jccfg(jx, TCCFG), jx.jgcfg)
    return jx.jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_transformer_map_prefix_matches_jax(precision, impl, jx, jparams_transformer):
    """map_prefix with the transformer mapper against the JAX package's op by op
    (jax.disable_jit()): [B, prefix_length, n_embd], the last prefix rows of
    the blocks' output. The plain impl composes each block's attention as the
    JAX package's XLA path does; the kernel impl takes the fused block (K1's
    plain version on the CPU), which rounds where the Pallas block does, so
    in bf16 it is held relative to the prefix's largest element."""
    from construction_clip_tpu_torch.ops.attention import use_impl

    emb = np.random.default_rng(6).standard_normal((B, CCFG.clip_dim)).astype(np.float32)
    mapper = jparams_transformer["mapper"]
    with jx.jax.disable_jit():
        want = jx.jmodel.map_prefix(mapper, _jccfg(jx, TCCFG), jx.jgcfg, jx.jnp.asarray(emb),
                                    **({} if precision == "fp32" else {"policy": jx.JBF16}))
    want = np.asarray(want, np.float32)
    with use_impl(impl):
        got = model.map_prefix(convert.to_params(mapper).tree(), TCCFG, GCFG,
                               torch.from_numpy(emb),
                               policy=BF16_POLICY if precision == "bf16" else DEFAULT_POLICY)
    assert got.shape == (B, TCCFG.prefix_length, GCFG.n_embd)
    rtol, atol = MAPPER_TOL[precision]
    if impl == "kernel" and precision == "bf16":
        assert float(np.abs(got.float().numpy() - want).max()) <= rtol * np.abs(want).max()
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mapper", ["mlp", "transformer"])
def test_init_mapper_shapes_equal_jax(mapper, jx):
    """convert.init_mapper's tree (and its SHAPES template) at the JAX
    package's init_mapper's keys, shapes and dtypes; the draws' scales."""
    ccfg = dataclasses.replace(TCCFG, mapper=mapper)
    want = jx.jmodel.init_mapper(jx.jax.random.key(0), _jccfg(jx, ccfg), jx.jgcfg)
    got, shapes = (convert.init_mapper(seed, ccfg, GCFG) for seed in (0, convert.SHAPES))
    for tree in (got, shapes):
        assert tree_map(lambda a: (a.shape, a.dtype.name), tree) == \
            tree_map(lambda a: (a.shape, a.dtype.name), jx.jax.tree.map(np.asarray, want))
    if mapper == "transformer":
        assert float(np.std(got["prefix_const"])) == pytest.approx(0.02, rel=0.2)
        assert float(np.std(got["blocks"]["mlp"]["w_proj"])) == pytest.approx(
            (2 * GCFG.n_embd) ** -0.5, rel=0.2)


@pytest.mark.parametrize("only_prefix", [True, False], ids=["only_prefix", "full"])
def test_transformer_mapper_train_steps_match_jax(only_prefix, jx, jparams_transformer):
    """test_train_steps_match_jax's 3 steps with the transformer mapper; the key
    third of each mapper block's b_qkv, whose gradient is rounding noise as
    GPT-2's c_attn_b's, is held to 2 lr a step as that is."""
    _steps_match_jax(jx, dataclasses.replace(TCCFG, only_prefix=only_prefix),
                     jparams_transformer)


def _train_app(tmp_path, name, extra, dim=16):
    """train_clipcap with the transformer mapper, one epoch on the CPU, fp32."""
    from construction_clip_tpu_torch.apps import train_clipcap

    _archive(tmp_path / f"{name}.npz", dim=dim)
    argv = ["--data", str(tmp_path / f"{name}.npz"), "--out_dir", str(tmp_path / "m"),
            "--prefix", name, "--epochs", "1", "--bs", "4", "--lr", "1e-3",
            "--warmup_steps", "0", "--gpt_size", "tiny", "--tokenizer", _vocab(tmp_path, 128),
            "--log_dir", str(tmp_path / "log"), "--device", "cpu", "--precision", "fp32",
            "--mapping_type", "transformer", *extra]
    train_clipcap.main(argv)
    return str(tmp_path / "m" / f"{name}.npz")


def test_app_trains_the_transformer_mapper(tmp_path, monkeypatch, capsys, jx):
    """train_clipcap --mapping_type transformer --num_layers 2: the npz holds the
    2-block mapper over --prefix_length_clip rows, trained from its init, and
    the JAX package's load_params_npz reads it at its shapes."""
    from construction_clip_tpu.train.checkpoint import load_params_npz as jload

    from construction_clip_tpu_torch.apps import train_clipcap
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    npz = _train_app(tmp_path, "tcap", ["--num_layers", "2", "--prefix_length_clip", "5",
                                        "--only_prefix"])
    assert "saved inference params" in capsys.readouterr().out
    ccfg = ClipCapConfig(clip_dim=16, mapper="transformer", mapper_layers=2, clip_length=5)
    saved = load_params_npz(npz, convert.init_clipcap(convert.SHAPES, ccfg, GCFG))
    assert saved["mapper"]["blocks"]["attn"]["w_qkv"].shape == (2, 32, 96)
    assert saved["mapper"]["proj"].shape == (16, 5 * 32)
    init = convert.init_clipcap(train_clipcap.INIT_SEED, ccfg, GCFG)
    assert not np.array_equal(saved["mapper"]["proj"], init["mapper"]["proj"])
    _tree_close(saved["gpt"], init["gpt"], atol=0)
    template = jx.jmodel.init_clipcap(jx.jax.random.key(0), _jccfg(jx, ccfg), jx.jgcfg)
    _tree_close(_np(jload(npz, template)), saved, atol=0)


@pytest.fixture(scope="module")
def predict_npz(tmp_path_factory):
    """A transformer-mapper npz that the predict and serve apps read: 8 blocks
    (their mapper) over 10 projected rows (their clip_length), trained on
    tiny CLIP's 32-wide embeddings."""
    tmp_path = tmp_path_factory.mktemp("tmapper")
    with pytest.MonkeyPatch.context() as mp:
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            mp.setitem(sys.modules, mod, None)
        return _train_app(tmp_path, "tmapper", ["--prefix_length_clip", "10"], dim=32)


def test_serve_service_captions_with_the_transformer_mapper(predict_npz, monkeypatch):
    """serve's build_service with --mapping_type transformer on the app's npz,
    beside the same service built from the npz's params by hand."""
    from construction_clip_tpu_torch.apps import serve
    from tests.test_torch_quant import TinyClipTok, TinyLMTok

    args = serve.parse_args(["--arch", "tiny", "--caption_checkpoint", predict_npz,
                             "--mapping_type", "transformer", "--greedy", "--device", "cpu"])
    svc = serve.build_service(args, TinyClipTok(), TinyLMTok(), torch.device("cpu"))
    mapper = svc.pipe._cap["mapper"]
    assert mapper["blocks"]["attn"]["w_qkv"].shape == (8, 32, 96)
    with np.load(predict_npz) as data:
        np.testing.assert_array_equal(mapper["proj"].numpy(), data["mapper/proj"])
    svc.pipe.max_steps = 4
    img = (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(np.uint8)
    out = svc.predict(img)
    assert out["caption_type"] in ("violation", "status") and isinstance(out["caption"], str)


def test_a_checkpoint_at_the_default_clip_length_does_not_load_into_predict(tmp_path, jx):
    """The reference's quirk, kept: train_clipcap's default --prefix_length_clip
    is 20, but predict (and serve, predict_t5) build the mapper at
    clip_length 10, so the checkpoint's mapper/proj has twice the columns
    predict wants. The port's predict refuses it naming mapper/proj, as the
    JAX package's load_params_npz does."""
    from construction_clip_tpu.train.checkpoint import load_params_npz as jload

    from construction_clip_tpu_torch.apps import predict

    with pytest.MonkeyPatch.context() as mp:
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            mp.setitem(sys.modules, mod, None)
        npz = _train_app(tmp_path, "dflt", [], dim=32)
    with np.load(npz) as data:
        assert data["mapper/proj"].shape == (32, 20 * 32)
    with pytest.raises(ValueError, match="'mapper/proj' has shape"):
        predict.main(["--arch", "tiny", "--caption_checkpoint", npz, "--mapping_type",
                      "transformer", "--device", "cpu", "--json_path", str(tmp_path / "none")])
    jccfg = jx.jconfigs.ClipCapConfig(clip_dim=32, mapper="transformer")
    with pytest.raises(AssertionError, match="mapper/proj"):
        jload(npz, jx.jmodel.init_clipcap(jx.jax.random.key(0), jccfg, jx.jgcfg))
