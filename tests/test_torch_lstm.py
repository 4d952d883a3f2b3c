"""PyTorch port, the show-attend-tell captioner (models/lstm_captioner.py,
train/lstm.py, models/resnet.resnet50_features, convert.init_lstm_captioner,
train/state.adam, the train_attention and eval_attention apps) against the
JAX package on the CPU, at the JAX tests' widths.

Dropout draws differ between JAX keys and torch.Generator, so the
comparisons run with dropout 0; the dropout path is held to a falling loss.
Tolerances: logits, alphas and losses within 1e-5 (fp32); greedy tokens
exact and alphas within 1e-6; 3 Adam steps within 1e-5 of JAX's params
(att_A's bias, whose gradient is rounding noise, within 3 steps of lr).

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous, at most 60 s a group). Each imports this module, which imports
no JAX at its top."""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.mesh import shard_batch, spawn_ranks
from construction_clip_tpu_torch.core.params import as_tree, tree_leaves, tree_map
from construction_clip_tpu_torch.models import lstm_captioner as tl
from construction_clip_tpu_torch.train import lstm as tlstm
from construction_clip_tpu_torch.train import state as tstate
from construction_clip_tpu_torch.train.grads import token_mean_grads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, E, ATT, ENC, DEC = 40, 12, 8, 10, 12   # tests/test_lstm_training.py's widths


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import optax

    from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
    from construction_clip_tpu.models import lstm_captioner as jl
    from construction_clip_tpu.models import resnet as jresnet
    from construction_clip_tpu.train import lstm as jlstm
    from construction_clip_tpu.train import state as jstate

    tree = jax.tree.map(np.asarray, jl.init_lstm_captioner(
        jax.random.key(0), vocab_size=V, embed_size=E, attention_dim=ATT, encoder_dim=ENC,
        decoder_dim=DEC))
    return types.SimpleNamespace(**locals())


def _batch(b=8, seed=1, t=6):
    gen = np.random.default_rng(seed)
    return {"features": gen.standard_normal((b, 9, ENC)).astype(np.float32),
            "tokens": gen.integers(1, V, (b, t)).astype(np.int32)}


def _uneven(batch):
    """Rows 0-3 mostly padding, rows 4-7 full: the ranks' token counts differ."""
    toks = batch["tokens"].copy()
    toks[:4, 2:] = 0
    return dict(batch, tokens=toks)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), as_tree(tree))


def _close(got, want, **tol):
    """Leaf by leaf, by key (a dict that jax.tree.map rebuilt has its keys
    sorted)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=str(tol), **tol)


def test_forward_and_loss_parts_match_jax(jx):
    b = _uneven(_batch())
    params = convert.to_params(jx.tree).tree()
    logits, alphas = tl.captioner_forward(params, torch.from_numpy(b["features"]),
                                          torch.from_numpy(b["tokens"]).long())
    want_l, want_a = jx.jl.captioner_forward(jx.tree, jx.jnp.asarray(b["features"]),
                                             jx.jnp.asarray(b["tokens"]))
    assert logits.shape == (8, 5, V) and alphas.shape == (8, 5, 9)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_l), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alphas.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
    total, count = tl.caption_lm_loss_parts(logits, torch.from_numpy(b["tokens"]))
    wt, wc = jx.jl.caption_lm_loss_parts(want_l, jx.jnp.asarray(b["tokens"]))
    np.testing.assert_allclose(float(total), float(wt), rtol=1e-5)
    assert float(count) == float(wc) == 4 * 1 + 4 * 5
    np.testing.assert_allclose(float(tl.caption_lm_loss(logits, torch.from_numpy(b["tokens"]))),
                               float(jx.jl.caption_lm_loss(want_l, jx.jnp.asarray(b["tokens"]))),
                               rtol=1e-5)


def test_generate_caption_matches_jax_and_the_golden(jx):
    """The golden's params (tests/test_goldens.py:96-105, made by JAX and
    carried across): tokens exact, alphas within 1e-6 of
    tests/goldens/lstm_tiny.npz. Then a batch of 3 whose first row stops at
    step 3 (eos = the token it emits there) while the others run on: tokens,
    lengths and alphas against JAX's, the steps after the stop zero."""
    jax = jx.jax
    tree = jx.jl.init_lstm_captioner(jax.random.key(13), vocab_size=30, embed_size=8,
                                     attention_dim=8, encoder_dim=12, decoder_dim=10)
    feats = np.asarray(jax.random.normal(jax.random.key(14), (1, 6, 12)))
    params = convert.to_params(jax.tree.map(np.asarray, tree)).tree()
    toks, lengths, alphas = tl.generate_caption(params, torch.from_numpy(feats), sos_id=1,
                                                eos_id=2, max_len=8)
    golden = np.load(os.path.join(REPO, "tests", "goldens", "lstm_tiny.npz"))
    np.testing.assert_array_equal(toks.numpy(), golden["tokens"])
    np.testing.assert_allclose(alphas.numpy(), golden["alphas"], rtol=1e-6, atol=1e-6)

    feats = np.random.default_rng(5).standard_normal((3, 6, 12)).astype(np.float32)
    free = tl.generate_caption(params, torch.from_numpy(feats), sos_id=1, eos_id=-1,
                               max_len=8)[0]
    eos = int(free[0, 2])
    got = tl.generate_caption(params, torch.from_numpy(feats), sos_id=1, eos_id=eos,
                              max_len=8)
    want = jx.jl.generate_caption(tree, jx.jnp.asarray(feats), sos_id=1, eos_id=eos, max_len=8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    assert int(got[1][0]) <= 3 and (got[0][0, int(got[1][0]):] == 0).all()


def test_resnet50_features_match_jax(jx):
    """The frozen encoder at 64 px on JAX's init_resnet50 tree (HWIO, carried
    across by to_detector_params): the [B, 4, 2048] grid in JAX's row order,
    within 1e-5 of its largest element (He-normal weights grow the maps)."""
    jax = jx.jax
    tree = jax.tree.map(np.asarray, jx.jresnet.init_resnet50(jax.random.key(3)))
    imgs = np.random.default_rng(6).standard_normal((2, 64, 64, 3)).astype(np.float32)
    from construction_clip_tpu_torch.models.resnet import resnet50_features

    with torch.no_grad():
        got = resnet50_features(convert.to_detector_params(tree), torch.from_numpy(imgs)).numpy()
    want = np.asarray(jax.jit(jx.jresnet.resnet50_features)(tree, jx.jnp.asarray(imgs)))
    assert got.shape == want.shape == (2, 4, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * float(np.abs(want).max()))


def test_init_lstm_captioner_has_the_jax_shapes(jx):
    port = convert.init_lstm_captioner(0, vocab_size=V, embed_size=E, attention_dim=ATT,
                                       encoder_dim=ENC, decoder_dim=DEC)
    assert jx.jax.tree.structure(port) == jx.jax.tree.structure(jx.tree)
    for p, j in zip(jx.jax.tree.leaves(port), jx.jax.tree.leaves(jx.tree)):
        assert p.shape == j.shape and p.dtype == j.dtype
    assert float(np.abs(port["w_ih"]).max()) <= DEC ** -0.5
    assert float(np.abs(port["att_U"]["w"]).max()) <= ENC ** -0.5


def test_from_torch_state_dict_gives_the_jax_tree(jx):
    """A DecoderRNN state dict (the reference's names, torch [out, in]
    weights) through both converters: the same arrays."""
    gen = np.random.default_rng(9)
    sd = {"embedding.weight": gen.standard_normal((V, E)),
          "lstm_cell.weight_ih": gen.standard_normal((4 * DEC, E + ENC)),
          "lstm_cell.weight_hh": gen.standard_normal((4 * DEC, DEC)),
          "lstm_cell.bias_ih": gen.standard_normal(4 * DEC),
          "lstm_cell.bias_hh": gen.standard_normal(4 * DEC)}
    for name, (i, o) in {"attention.W": (DEC, ATT), "attention.U": (ENC, ATT),
                         "attention.A": (ATT, 1), "init_h": (ENC, DEC), "init_c": (ENC, DEC),
                         "fcn": (DEC, V)}.items():
        sd[f"{name}.weight"] = gen.standard_normal((o, i))
        sd[f"{name}.bias"] = gen.standard_normal(o)
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    _close(tl.from_torch_state_dict(sd, vocab_size=V),
           jx.jax.tree.map(np.asarray, jx.jl.from_torch_state_dict(sd, vocab_size=V)),
           rtol=0, atol=0)


def test_three_adam_steps_match_jax(jx):
    """make_lstm_train_step with adam(3e-3), dropout 0, 3 steps on one batch,
    against the JAX step on a one-device mesh with optax.adam."""
    jax = jx.jax
    b = _uneven(_batch())
    mesh = jx.create_mesh({jx.DATA_AXIS: 1, jx.MODEL_AXIS: 1}, devices=jax.devices()[:1])
    jtx = jx.optax.adam(3e-3)
    jstep = jx.jlstm.make_lstm_train_step(jtx, mesh, dropout_rate=0.0)
    jst = jx.jstate.TrainState.create(jax.tree.map(jx.jnp.array, jx.tree), jtx)
    tx = tstate.adam(3e-3)
    st = tstate.TrainState.create(convert.to_params(jx.tree, trainable=True), tx)
    step = tlstm.make_lstm_train_step(tx, dropout_rate=0.0)
    for i in range(3):
        jst, jm = jstep(jst, {k: jx.jnp.asarray(v) for k, v in b.items()}, jax.random.key(i))
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    got, want = _np(st.params), jax.tree.map(np.asarray, jst.params)
    # att_A's bias shifts every score alike, which the softmax takes out: its
    # gradient is 0 but for rounding, which Adam's g / sqrt(v) turns into
    # steps of up to lr in either package; it is held to 3 steps of lr
    np.testing.assert_allclose(got["att_A"].pop("b"), want["att_A"].pop("b"), atol=3 * 3e-3)
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_loss_falls_with_dropout(jx):
    b = _batch()
    tx = tstate.adam(5e-3)
    st = tstate.TrainState.create(convert.to_params(jx.tree, trainable=True), tx)
    step = tlstm.make_lstm_train_step(tx, dropout_rate=0.3)
    losses = []
    for i in range(8):
        st, m = step(st, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    # the dropout masks come from the seed: the same seed gives the same loss
    again = tstate.TrainState.create(convert.to_params(jx.tree, trainable=True), tx)
    _, m0 = step(again, {k: torch.from_numpy(v) for k, v in b.items()}, 0)
    assert float(m0["loss"]) == losses[0]


def _sgd(lr):
    return tstate.GradientTransformation(
        lambda params: (), lambda g, s, params=None: (tree_map(lambda x: -lr * x, g), s))


def _dp_rank(dp, case):
    """This rank's rows: the loss and gradients of the global token mean,
    then one SGD step of make_lstm_train_step."""
    rows = {k: torch.from_numpy(v) for k, v in shard_batch(dp, case["batch"]).items()}
    params = convert.to_params(case["tree"], trainable=True)
    logits, _ = tl.captioner_forward(params.tree(), rows["features"], rows["tokens"].long())
    total, count = tl.caption_lm_loss_parts(logits, rows["tokens"])
    loss, grads = token_mean_grads(total, count, params.tree(), dp)
    st = tstate.TrainState.create(params, _sgd(0.1))
    st, m = tlstm.make_lstm_train_step(_sgd(0.1), dp=dp, dropout_rate=0.0)(st, rows, 2)
    return float(loss), _np(grads), float(m["loss"]), _np(st.params)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_with_uneven_padding_equal_one_process(jx, world):
    """JAX's test_dp_loss_equals_single_device_uneven_padding: rows 0-3 mostly
    padding, rows 4-7 full, so the ranks' token counts differ; the loss (the
    global token mean), every gradient and the SGD step's params equal the
    one process's."""
    case = {"batch": _uneven(_batch()), "tree": jx.tree}
    ranks = spawn_ranks(_dp_rank, world, (case,), device="cpu", timeout=60)
    one = _dp_rank(types.SimpleNamespace(rank=0, world=1, device=torch.device("cpu")), case)
    for loss, grads, step_loss, params in ranks:
        np.testing.assert_allclose(loss, one[0], rtol=1e-5)
        np.testing.assert_allclose(step_loss, one[2], rtol=1e-5)
        # both trees in the port's order; att_A's bias has a gradient of 0 but for
        # rounding (~1e-10), held to 1e-8
        for g, w in zip(tree_leaves(grads), tree_leaves(one[1])):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=max(1e-6 * float(np.abs(w).max()), 1e-8))
        _close(params, one[3], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(256, 256), (96, 160), (7, 7), (5, 3)])
def test_resize_bilinear_matches_jax_image_resize(jx, out_hw):
    """The overlay's upsample (infer/explain.resize_bilinear) against
    jax.image.resize(..., "bilinear"), as eval_attention's JAX app draws it."""
    from construction_clip_tpu_torch.infer.explain import resize_bilinear

    a7 = np.random.default_rng(8).random((7, 7)).astype(np.float32)
    want = np.asarray(jx.jax.image.resize(jx.jnp.asarray(a7), out_hw, "bilinear"))
    np.testing.assert_allclose(resize_bilinear(a7, out_hw), want, rtol=1e-5, atol=1e-6)


def _corpus(root):
    """10 PIL-written JPEGs with Chinese captions over a 6-word pool."""
    import json

    from PIL import Image

    gen = np.random.default_rng(4)
    words = ["工地", "邊緣", "墜落", "護欄", "開口", "機械"]
    anns = []
    for i in range(10):
        fn = f"im{i}.jpg"
        Image.fromarray((gen.random((60, 80, 3)) * 255).astype(np.uint8)).save(root / fn)
        caption = " ".join(gen.choice(words, size=3))
        anns.append({"id": i, "caption_type": "violation", "violation_type": "墜落",
                     "violation_list": "", "caption": caption, "file_name": fn, "objects": ""})
    (root / "all.json").write_text(json.dumps({"type": "captions", "annotations": anns},
                                              ensure_ascii=False), encoding="utf-8")


WIDTHS = ["--embed_size", "8", "--attention_dim", "8", "--decoder_dim", "16",
          "--freq_threshold", "1"]


def _run(module, args, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", f"construction_clip_tpu_torch.apps.{module}",
                          *args, "--device", "cpu"], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_apps_train_then_eval_on_the_cpu(tmp_path):
    """train_attention for one epoch (2 steps of 4 of the 10 images), then
    eval_attention --limit 2 on its checkpoint, each in a subprocess: the
    eval's captions are generate_caption's on the restored params, and its
    overlay PNGs are written."""
    from construction_clip_tpu_torch.apps import eval_attention, train_attention
    from construction_clip_tpu_torch.data.pipeline import default_load_image, host_shape_unify
    from construction_clip_tpu_torch.train.checkpoint import restore_state

    _corpus(tmp_path)
    common = ["--json_path", str(tmp_path / "all.json"), "--image_root", str(tmp_path)] + WIDTHS
    out = _run("train_attention", common + ["--epochs", "1", "--batch_size", "4",
                                            "--output_dir", str(tmp_path / "ckpt"),
                                            "--log_dir", str(tmp_path / "log")], tmp_path)
    # the vocabulary: 4 specials and the corpus's characters (CJK splits per character)
    assert re.search(r"^10 captions, vocab 1\d$", out, flags=re.M), out
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_0.pt", "step_1.pt"]
    out = _run("eval_attention", common + ["--checkpoint", str(tmp_path / "ckpt"),
                                           "--limit", "2", "--output_dir",
                                           str(tmp_path / "eval")], tmp_path)
    printed = dict(re.findall(r"^(im\d+\.jpg): (.*)$", out, flags=re.M))
    assert sorted(printed) == ["im0.jpg", "im1.jpg"]
    assert sorted(os.listdir(tmp_path / "eval")) == ["im0.jpg.attn.png", "im1.jpg.attn.png"]

    args = eval_attention.parse_args(common)
    anns, _, vocab = train_attention.load_corpus(args.json_path, args.freq_threshold)
    params = train_attention.init_captioner(args, len(vocab), torch.device("cpu"))
    restored = restore_state(str(tmp_path / "ckpt"),
                             tstate.TrainState.create(params, tstate.adam(1e-3)))
    assert restored.step == 2
    params = restored.params
    caption = eval_attention.make_captioner(train_attention.load_encoder(None, "cpu"), params,
                                            vocab, max_len=args.max_len)
    for name, text in printed.items():
        u8 = host_shape_unify(default_load_image(str(tmp_path / name)), 256)
        words, alphas = caption(u8)
        assert " ".join(words) == text
        assert alphas.shape == (args.max_len, 49)
