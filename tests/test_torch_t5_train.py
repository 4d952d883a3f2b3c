"""PyTorch port, ClipCap mT5 caption training against the JAX package (CPU): the
training forward and its loss, 3 steps of make_t5_caption_train_step in both
modes, the 2-rank data-parallel step against one process, and the
train_clipcap_t5 app.

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
from construction_clip_tpu_torch.core.configs import ClipCapConfig, T5Config
from construction_clip_tpu_torch.core.mesh import shard_batch, spawn_ranks
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY
from construction_clip_tpu_torch.models.clipcap import t5_model
from construction_clip_tpu_torch.train import state
from construction_clip_tpu_torch.train import t5 as t5_train

TCFG = T5Config.tiny()
CCFG = ClipCapConfig(prefix_length=3, attribute_length=0, clip_dim=16)
B, T = 4, 6
LR = 1e-4


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.core import configs as jconfigs
    from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
    from construction_clip_tpu.core.precision import BF16_POLICY as JBF16
    from construction_clip_tpu.models.clipcap import t5_model as jmodel
    from construction_clip_tpu.train import state as jstate
    from construction_clip_tpu.train import t5 as jtrain

    jtcfg = jconfigs.T5Config.tiny()
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
    tree = jx.jmodel.init_clipcap_t5(jx.jax.random.key(3), _jccfg(jx, CCFG), jx.jtcfg)
    return jx.jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(seed, b=B, t=T):
    """Captions of uneven length, zero-padded (one row of a single token)."""
    gen = np.random.default_rng(seed)
    ids = gen.integers(2, TCFG.vocab_size, (b, t)).astype(np.int32)
    for i, n in enumerate([t, 4, 1, 3, 5, 2, 6, 2][:b]):
        ids[i, n:] = 0
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32),
            "prefix": gen.standard_normal((b, CCFG.clip_dim)).astype(np.float32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(jx, batch):
    return {k: jx.jnp.asarray(v) for k, v in batch.items()}


# ---- forward and loss --------------------------------------------------------------------

# (rtol, atol) of the logits against JAX's op by op: fp32 by summation order in
# a 2+2-layer model; bf16 by single roundings of an activation that another
# order of the fp32 sums can flip (one bf16 step is 2^-8 relative), as the
# GPT-2 caption test holds it
FORWARD_TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 2e-2)}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_and_loss_match_jax(precision, jx, jparams):
    """clipcap_t5_forward's logits and t5_caption_loss(_parts) on rows of
    uneven padding, against the JAX package evaluated op by op
    (jax.disable_jit(): a jitted XLA program fuses bf16 chains and skips
    their roundings)."""
    batch = _batch(0)
    kw = {} if precision == "fp32" else {"policy": jx.JBF16}
    jb = _jnp(jx, batch)
    with jx.jax.disable_jit():
        want = jx.jmodel.clipcap_t5_forward(
            jparams, _jccfg(jx, CCFG), jx.jtcfg, input_ids=jb["input_ids"],
            attention_mask=jb["attention_mask"], clip_embed=jb["prefix"], **kw)
        want_parts = jx.jmodel.t5_caption_loss_parts(want, jb["input_ids"], _jccfg(jx, CCFG))
        want_loss = jx.jmodel.t5_caption_loss(want, jb["input_ids"], _jccfg(jx, CCFG))
    tb = _torch(batch)
    got = t5_model.clipcap_t5_forward(
        convert.to_params(jparams).tree(), CCFG, TCFG, input_ids=tb["input_ids"],
        attention_mask=tb["attention_mask"], clip_embed=tb["prefix"],
        policy=BF16_POLICY if precision == "bf16" else DEFAULT_POLICY)
    assert got.dtype == torch.float32 and got.shape == (B, 3 + T, TCFG.vocab_size)
    rtol, atol = FORWARD_TOL[precision]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)
    total, count = t5_model.t5_caption_loss_parts(got, tb["input_ids"], CCFG)
    assert float(count) == float(want_parts[1]) == 6 + 4 + 1 + 3
    np.testing.assert_allclose(float(total), float(want_parts[0]), rtol=rtol)
    np.testing.assert_allclose(float(t5_model.t5_caption_loss(got, tb["input_ids"], CCFG)),
                               float(want_loss), rtol=rtol)


def test_loss_takes_the_prefix_aligned_slice_and_ignores_padding():
    """Position prefix_length - 1 + j predicts caption token j; padding ids
    count nothing, and a batch without a valid token has loss 0."""
    logits = torch.randn(2, 3 + 3, TCFG.vocab_size)
    ids = torch.tensor([[5, 0, 0], [7, 9, 0]])
    total, count = t5_model.t5_caption_loss_parts(logits, ids, CCFG)
    logp = torch.log_softmax(logits[:, 2:-1], dim=-1)
    want = -(logp[0, 0, 5] + logp[1, 0, 7] + logp[1, 1, 9])
    assert float(count) == 3
    torch.testing.assert_close(total, want)
    assert float(t5_model.t5_caption_loss(logits, torch.zeros_like(ids), CCFG)) == 0.0


# ---- three train steps against JAX ---------------------------------------------------------

# A gradient element below this share of its leaf's largest (and not exactly
# zero, as the rows of tokens and buckets that a batch does not use are on
# both sides) is rounding noise to AdamW: the two packages' fp32 sums agree to ~1e-6 of the largest element
# (the step-1 readings: 5e-7 to 8e-7), so such an element's relative error
# reaches 1%, and AdamW, which divides each element by its own magnitude,
# turns that into an update difference of up to 2 lr a step.
NOISE_SHARE = 1e-4


def _jax_grads(jx, jccfg, trainable, frozen, batch):
    """jax.grad of the JAX step's loss (one device) at `trainable`."""
    def loss_fn(tr):
        params = {"mapper": tr, "t5": frozen} if jccfg.only_prefix else tr
        logits = jx.jmodel.clipcap_t5_forward(
            params, jccfg, jx.jtcfg, input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"], clip_embed=batch["prefix"])
        return jx.jmodel.t5_caption_loss(logits, batch["input_ids"], jccfg)

    return jx.jax.grad(loss_fn)(trainable)


def _either(a, b):
    if isinstance(a, dict):
        return {k: _either(a[k], b[k]) for k in a}
    return a | b


@pytest.mark.parametrize("only_prefix", [True, False], ids=["only_prefix", "full"])
def test_train_steps_match_jax(only_prefix, jx, jparams):
    """3 steps from the same params and batches against the JAX package's
    make_t5_caption_train_step on a 1-device mesh, fp32. Each step's
    gradients (loss_and_grads at the JAX state's params) against jax.grad,
    every leaf to 1e-5 of its largest element; the loss to 1e-5 relative
    each step; every trainable leaf after step 3 to 2e-6 absolute: AdamW
    moves a weight by at most about lr = 1e-4 a step, carrying the
    gradient's relative error (~1e-6). The exception is an element whose
    gradient at some step is below NOISE_SHARE of its leaf's largest: AdamW normalises its rounding
    noise into the update, so the two sides may move apart by up to 2 lr a
    step, and it is held to 2 x steps x lr alone; such elements must stay
    under 5% of every leaf (0.1-1.8% here: the lm_head's share is the
    largest). In only-prefix mode the frozen T5 stays
    bit-equal to its start."""
    _steps_match_jax(jx, dataclasses.replace(CCFG, only_prefix=only_prefix), jparams)


def _steps_match_jax(jx, ccfg, jparams):
    jccfg = _jccfg(jx, ccfg)
    kw = dict(warmup_steps=0, total_steps=100)
    jtx, ttx = jx.jstate.make_adamw(LR, **kw), state.make_adamw(LR, **kw)
    jstep = jx.jtrain.make_t5_caption_train_step(jccfg, jx.jtcfg, jtx, jx.mesh)
    tstep = t5_train.make_t5_caption_train_step(ccfg, TCFG, ttx)
    jtree = jx.jax.tree.map(jx.jnp.asarray, jparams)
    if ccfg.only_prefix:
        jst, jfrozen = jx.jstate.TrainState.create(jtree["mapper"], jtx), jtree["t5"]
        t5 = convert.to_params(jparams["t5"]).tree()
        tst = state.TrainState.create(convert.to_params(jparams["mapper"], trainable=True), ttx)
    else:
        jst, jfrozen, t5 = jx.jstate.TrainState.create(jtree, jtx), None, None
        tst = state.TrainState.create(convert.to_params(jparams, trainable=True), ttx)
    noise = None
    for i in range(3):
        batch = _batch(10 + i)
        want_g = _np(_jax_grads(jx, jccfg, jst.params, jfrozen, _jnp(jx, batch)))
        _, got_g = t5_train.loss_and_grads(
            convert.to_params(_np(jst.params), trainable=True), t5, ccfg, TCFG, _torch(batch))
        _tree_close(_np(got_g), want_g, atol=None, rel_to_max=1e-5)
        small = tree_map(lambda g: (g != 0) & (np.abs(g) < NOISE_SHARE * np.abs(g).max()),
                         want_g)
        noise = small if noise is None else _either(noise, small)
        jst, jm = jstep(jst, jfrozen, _jnp(jx, batch))
        tst, tm = tstep(tst, t5, _torch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    shares = [_noise_share(path, m) for path, m in zip(_paths(noise), tree_leaves(noise))]
    assert max(shares) < 0.05, dict(zip(_paths(noise), shares))
    got, want = _np(as_tree(tst.params)), _np(jst.params)
    _tree_close(got, want, atol=2e-6, noise=noise, noise_atol=2 * 3 * LR)
    assert tst.step == int(jst.step) == 3
    assert len(tree_leaves(tst.opt_state["m"])) == len(jx.jax.tree.leaves(want))
    if ccfg.only_prefix:
        _tree_close(_np(t5), jparams["t5"], atol=0)


def _noise_share(path, noise):
    """The share of a leaf's elements whose gradient was rounding noise, the key
    third of a transformer-mapper block's b_qkv left out: its gradient is
    mathematically zero (softmax does not change when every logit of a row
    moves by q.b_k), so all of it is noise, held to the noise bound."""
    if path.endswith("/attn/b_qkv"):
        d = noise.shape[-1] // 3
        noise = np.delete(noise, np.s_[d:2 * d], -1)
    return float(noise.mean())


def _tree_close(got, want, atol, path="", *, rel_to_max=None, noise=None, noise_atol=None):
    """Every leaf within `atol` (or within `rel_to_max` of its largest
    element); the elements that `noise` marks within `noise_atol` instead."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_close(got[k], want[k], atol, f"{path}/{k}", rel_to_max=rel_to_max,
                        noise=None if noise is None else noise[k], noise_atol=noise_atol)
        return
    if rel_to_max is not None:
        atol = rel_to_max * float(np.abs(want).max())
    if noise is not None:
        np.testing.assert_allclose(got[noise], want[noise], rtol=0, atol=noise_atol,
                                   err_msg=path)
        got, want = got[~noise], want[~noise]
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)


def test_the_step_casts_each_trainable_leaf_once(jparams):
    """Under the bf16 policy a full fine-tune step casts each trainable fp32
    leaf to bf16 once: the autograd graph holds one cast (ToCopyBackward)
    above every leaf, although t5_encode and t5_decode each cast the T5 tree
    they are given."""
    params = convert.to_params(jparams, trainable=True)
    tb = _torch(_batch(1))
    cast = BF16_POLICY.cast_to_compute(as_tree(params))
    logits = t5_model.clipcap_t5_forward(
        cast, CCFG, TCFG, input_ids=tb["input_ids"], attention_mask=tb["attention_mask"],
        clip_embed=tb["prefix"], policy=BF16_POLICY)
    loss = t5_model.t5_caption_loss(logits, tb["input_ids"], CCFG)
    leaves = {id(p) for p in tree_leaves(as_tree(params))}
    casts, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for child, _ in node.next_functions:
            if child is not None and hasattr(child, "variable") and id(child.variable) in leaves:
                casts.setdefault(id(child.variable), []).append(type(node).__name__)
            todo.append(child)
    assert len(casts) == len(leaves)
    assert all(names == ["ToCopyBackward0"] for names in casts.values()), casts


def test_bf16_step_trains_fp32_masters(jparams):
    """Under the bf16 policy the params and AdamW's moments stay fp32, the
    frozen T5 cast once before the steps is used as it is, and the loss falls
    over 3 steps on one batch."""
    ttx = state.make_adamw(1e-3, warmup_steps=0, total_steps=100)
    step = t5_train.make_t5_caption_train_step(CCFG, TCFG, ttx, policy=BF16_POLICY)
    t5 = BF16_POLICY.cast_to_compute(convert.to_params(jparams["t5"]).tree())
    tst = state.TrainState.create(convert.to_params(jparams["mapper"], trainable=True), ttx)
    batch = _torch(_batch(3))
    losses = []
    for _ in range(3):
        tst, m = step(tst, t5, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in tree_leaves(as_tree(tst.params)))
    assert all(v.dtype == torch.float32 for v in tree_leaves(tst.opt_state["v"]))
    assert all(leaf.dtype == torch.bfloat16 for leaf in tree_leaves(t5))


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
    frozen = convert.to_params(case["params"]["t5"]).tree()
    mapper = convert.to_params(case["params"]["mapper"], trainable=True)
    only = dataclasses.replace(CCFG, only_prefix=True)
    loss, grads = t5_train.loss_and_grads(mapper, frozen, only, TCFG, rows, dp=dp)
    out = {"loss": float(loss), "grads": _np(grads)}
    st = state.TrainState.create(mapper, _sgd(0.1))
    st, m = t5_train.make_t5_caption_train_step(only, TCFG, _sgd(0.1), dp=dp)(st, frozen, rows)
    out["sgd"] = (float(m["loss"]), _np(as_tree(st.params)))
    full = dataclasses.replace(CCFG, only_prefix=False)
    tx = state.make_adamw(LR, warmup_steps=0, total_steps=100)
    st = state.TrainState.create(convert.to_params(case["params"], trainable=True), tx)
    st, m = t5_train.make_t5_caption_train_step(full, TCFG, tx, dp=dp)(st, None, rows)
    out["adamw"] = (float(m["loss"]), _np(as_tree(st.params)))
    return out


def test_two_ranks_with_uneven_padding_equal_one_process(jparams):
    """2 gloo ranks whose rows carry different amounts of padding (rank 0's
    rows 6 and 4 valid tokens, rank 1's 1 and 3) against the one-process step
    on the global batch, as the JAX package's 4-device test holds its psum:
    the loss (the global token mean, not the mean of the ranks' means) and
    every summed gradient leaf to 1e-5 relative; one SGD step's params to
    1e-6; one AdamW full fine-tune step's params to 2e-6."""
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
        _tree_close(r["adamw"][1], one["adamw"][1], atol=2e-6)


# ---- the app -------------------------------------------------------------------------------

# 110 CJK characters: with the specials and a few merges the BPE vocab passes
# the tiny T5's 100 rows, so the app must grow the table
CHARS = "".join(chr(0x5de5 + i) for i in range(110))


def _archive(path, n=10, dim=16):
    gen = np.random.default_rng(4)
    caps = [" ".join("".join(gen.choice(list(CHARS), size=2)) for _ in range(int(k)))
            for k in gen.integers(1, 5, n)]
    np.savez(path, embeddings=gen.standard_normal((n, dim)).astype(np.float32),
             attributes=np.asarray(["缺失 墜落 "] * n, dtype=object),
             captions=np.asarray(caps, dtype=object))
    return caps


def _bpe(tmp_path, captions):
    """A `tokenizers` BPE JSON trained by the port's train_tokenizer app on the
    captions and a line of every character of CHARS."""
    from construction_clip_tpu_torch.apps import train_tokenizer

    txt = tmp_path / "text.txt"
    txt.write_text("\n".join(captions + [" ".join(CHARS)]) + "\n", encoding="utf-8")
    out = str(tmp_path / "bpe.json")
    train_tokenizer.main(["--input", str(txt), "--out", out, "--vocab_size", "120",
                          "--min_frequency", "1"])
    return out


def test_app_trains_only_the_prefix_resumes_and_writes_npz(tmp_path, capsys, monkeypatch, jx):
    """train_clipcap_t5 --only_prefix on the CPU: one epoch, then two resuming
    from the first's checkpoint; the npz carries the mapper it trained and T5
    as initialised (its vocab fitted to the tokenizer), and loads into the JAX
    package at its shapes."""
    from construction_clip_tpu.train.checkpoint import load_params_npz as jload

    from construction_clip_tpu_torch.apps import train_clipcap_t5
    from construction_clip_tpu_torch.apps.common import TokenizerFile, fit_t5_vocab
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    caps = _archive(tmp_path / "emb.npz")
    tok = _bpe(tmp_path, caps)
    tcfg = fit_t5_vocab(TCFG, TokenizerFile(tok))
    assert 100 < TokenizerFile(tok).vocab_size() <= tcfg.vocab_size == 128
    argv = ["--data", str(tmp_path / "emb.npz"), "--out_dir", str(tmp_path / "m"),
            "--prefix", "t5cap", "--save_every", "1", "--bs", "4", "--lr", "1e-3",
            "--warmup_steps", "0", "--t5_size", "tiny", "--tokenizer", tok,
            "--max_length", "8", "--log_dir", str(tmp_path / "log"), "--device", "cpu",
            "--precision", "fp32", "--only_prefix", "--prefix_length", "4"]
    train_clipcap_t5.main(argv + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "Train only prefix" in out and "saved inference params" in out
    train_clipcap_t5.main(argv + ["--epochs", "2"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "m" / "t5cap")) == ["step_0.pt", "step_1.pt",
                                                           "step_2.pt"]
    logs = [json.loads(line) for line in open(tmp_path / "log" / "t5cap.jsonl")]
    assert [r["step"] for r in logs] == [2, 4]   # 10 items, 4 a step, 2 epochs
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=0, clip_dim=16)
    saved = load_params_npz(str(tmp_path / "m" / "t5cap.npz"),
                            convert.init_clipcap_t5(convert.SHAPES, ccfg, tcfg))
    init = convert.init_clipcap_t5(train_clipcap_t5.INIT_SEED, ccfg, tcfg)
    _tree_close(saved["t5"], init["t5"], atol=0)
    assert not np.array_equal(saved["mapper"]["w2"], init["mapper"]["w2"])
    jtcfg = jx.jconfigs.T5Config(**dataclasses.asdict(tcfg))
    template = jx.jmodel.init_clipcap_t5(jx.jax.random.key(0), _jccfg(jx, ccfg), jtcfg)
    jloaded = jload(str(tmp_path / "m" / "t5cap.npz"), template)
    _tree_close(_np(jloaded), saved, atol=0)


def test_app_tokenizes_captions_as_the_jax_app(tmp_path):
    """The captions cut to --max_length ids and zero-padded, with their
    attention mask: the arrays of the JAX app's inline loop."""
    from construction_clip_tpu_torch.apps.common import TokenizerFile
    from construction_clip_tpu_torch.apps.train_clipcap_t5 import tokenize_captions

    caps = _archive(tmp_path / "emb.npz") + ["", "工地 " * 20]
    tok = TokenizerFile(_bpe(tmp_path, caps))
    got = tokenize_captions(np.asarray(caps, dtype=object), tok, 8)
    want = np.zeros((len(caps), 8), np.int32)
    for i, c in enumerate(caps):
        enc = tok.encode(str(c))[:8]
        want[i, :len(enc)] = enc
    np.testing.assert_array_equal(got["input_ids"], want)
    np.testing.assert_array_equal(got["attention_mask"], (want != 0).astype(np.int32))
    assert got["input_ids"][-1].all() and not got["input_ids"][-2].any()


# ---- the transformer mapper ----------------------------------------------------------------

# 2 mapper blocks over 3 projected rows and the 3-row prefix constant, 8 heads of
# the tiny T5's width 32 (dh 4)
TCCFG = dataclasses.replace(CCFG, mapper="transformer", mapper_layers=2, clip_length=3)


@pytest.fixture(scope="module")
def jparams_transformer(jx):
    tree = jx.jmodel.init_clipcap_t5(jx.jax.random.key(4), _jccfg(jx, TCCFG), jx.jtcfg)
    return jx.jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_transformer_mapper_forward_matches_jax(precision, impl, jx, jparams_transformer):
    """clipcap_t5_forward with the transformer mapper (sized by the T5 width,
    t5_model.mapper_shape) against the JAX package op by op, at
    test_forward_and_loss_match_jax's tolerances. The kernel impl's mapper
    takes the fused block (K1's plain version on the CPU), which rounds where
    the Pallas block does, so in bf16 it is held relative to the largest
    logit."""
    from construction_clip_tpu_torch.ops.attention import use_impl

    batch = _batch(1)
    kw = {} if precision == "fp32" else {"policy": jx.JBF16}
    jb = _jnp(jx, batch)
    with jx.jax.disable_jit():
        want = jx.jmodel.clipcap_t5_forward(
            jparams_transformer, _jccfg(jx, TCCFG), jx.jtcfg, input_ids=jb["input_ids"],
            attention_mask=jb["attention_mask"], clip_embed=jb["prefix"], **kw)
    want = np.asarray(want)
    tb = _torch(batch)
    with use_impl(impl):
        got = t5_model.clipcap_t5_forward(
            convert.to_params(jparams_transformer).tree(), TCCFG, TCFG,
            input_ids=tb["input_ids"], attention_mask=tb["attention_mask"],
            clip_embed=tb["prefix"], policy=BF16_POLICY if precision == "bf16" else DEFAULT_POLICY)
    rtol, atol = FORWARD_TOL[precision]
    if impl == "kernel" and precision == "bf16":
        assert float(np.abs(got.numpy() - want).max()) <= rtol * np.abs(want).max()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("only_prefix", [True, False], ids=["only_prefix", "full"])
def test_transformer_mapper_train_steps_match_jax(only_prefix, jx, jparams_transformer):
    """test_train_steps_match_jax's 3 steps, gradients and bounds with the
    transformer mapper."""
    _steps_match_jax(jx, dataclasses.replace(TCCFG, only_prefix=only_prefix),
                     jparams_transformer)


def _train_app(tmp_path, name, extra, dim=16):
    """train_clipcap_t5 with the transformer mapper, one epoch on the CPU, fp32;
    -> (npz, tokenizer JSON, the fitted T5Config)."""
    from construction_clip_tpu_torch.apps import train_clipcap_t5
    from construction_clip_tpu_torch.apps.common import TokenizerFile, fit_t5_vocab

    caps = _archive(tmp_path / f"{name}.npz", dim=dim)
    tok = _bpe(tmp_path, caps)
    train_clipcap_t5.main(["--data", str(tmp_path / f"{name}.npz"),
                           "--out_dir", str(tmp_path / "m"), "--prefix", name, "--epochs", "1",
                           "--bs", "4", "--lr", "1e-3", "--warmup_steps", "0",
                           "--t5_size", "tiny", "--tokenizer", tok, "--max_length", "8",
                           "--log_dir", str(tmp_path / "log"), "--device", "cpu",
                           "--precision", "fp32", "--prefix_length", "4",
                           "--mapping_type", "transformer", *extra])
    return str(tmp_path / "m" / f"{name}.npz"), tok, fit_t5_vocab(TCFG, TokenizerFile(tok))


def test_app_trains_the_transformer_mapper(tmp_path, monkeypatch, jx):
    """train_clipcap_t5 --mapping_type transformer --num_layers 2 (a full
    fine-tune): the npz holds the 2-block mapper, trained, and the JAX
    package's load_params_npz reads it at its shapes."""
    from construction_clip_tpu.train.checkpoint import load_params_npz as jload

    from construction_clip_tpu_torch.apps import train_clipcap_t5
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    npz, _, tcfg = _train_app(tmp_path, "t5t", ["--num_layers", "2"])
    ccfg = ClipCapConfig(prefix_length=4, attribute_length=0, clip_dim=16,
                         mapper="transformer", mapper_layers=2, clip_length=20)
    saved = load_params_npz(npz, convert.init_clipcap_t5(convert.SHAPES, ccfg, tcfg))
    assert saved["mapper"]["blocks"]["mlp"]["w_fc"].shape == (2, 32, 64)
    init = convert.init_clipcap_t5(train_clipcap_t5.INIT_SEED, ccfg, tcfg)
    assert not np.array_equal(saved["mapper"]["proj"], init["mapper"]["proj"])
    jtcfg = jx.jconfigs.T5Config(**dataclasses.asdict(tcfg))
    template = jx.jmodel.init_clipcap_t5(jx.jax.random.key(0), _jccfg(jx, ccfg), jtcfg)
    _tree_close(_np(jload(npz, template)), saved, atol=0)


def test_predict_t5_captions_with_the_transformer_mapper(tmp_path, monkeypatch):
    """predict_t5's batch function with --mapping_type transformer on a
    train_clipcap_t5 npz that it reads (8 blocks over 10 projected rows, as
    the app builds the mapper), greedy, on the CPU: a caption an image."""
    from construction_clip_tpu_torch.apps import predict_t5
    from construction_clip_tpu_torch.apps.common import TokenizerFile
    from construction_clip_tpu_torch.core.configs import CLIPConfig
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz
    from tests.test_torch_quant import TinyClipTok

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    npz, tok, tcfg = _train_app(tmp_path, "t5p", ["--prefix_length_clip", "10"], dim=32)
    clip_cfg = CLIPConfig.tiny()
    args = predict_t5.parse_args(["--mapping_type", "transformer", "--prefix_length", "4"])
    ccfg = ClipCapConfig(prefix_length=args.prefix_length, attribute_length=0,
                         clip_dim=clip_cfg.text.embed_dim, mapper=args.mapping_type)
    cap = load_params_npz(npz, convert.init_clipcap_t5(convert.SHAPES, ccfg, tcfg))
    process = predict_t5.make_process(
        convert.to_params(convert.init_clip(0, clip_cfg)).tree(), clip_cfg,
        convert.to_params(cap).tree(), ccfg, tcfg, TinyClipTok(), TokenizerFile(tok),
        max_length=6, greedy=True, policy=DEFAULT_POLICY, device="cpu")
    staged = (np.random.default_rng(0).random((2, 40, 40, 3)) * 255).astype(np.uint8)
    records, res = process([Annotation(id=i, file_name=f"{i}.jpg") for i in range(2)], staged)
    assert len(records) == 2 and all(isinstance(r["caption"], str) for r in records)
    assert res.tokens.shape == (2, 6)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    else:
        yield prefix
