"""PyTorch port, contrastive fine-tuning against the JAX package: the optimizer,
the schedule, the loss, three train steps (through the Pallas kernels in
interpret mode on the JAX side, and the plain versions of K1/K3 and K4/K5 on
the port's side), the npz interchange, and the port's CLI end to end."""

import functools
import itertools
import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
from construction_clip_tpu.models.clip import init_clip
from construction_clip_tpu.ops import attention as jattention
from construction_clip_tpu.parallel import infonce as jinfonce
from construction_clip_tpu.train import checkpoint as jckpt
from construction_clip_tpu.train import contrastive as jcontrastive
from construction_clip_tpu.train import state as jstate
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig, TextConfig, VisionConfig
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.ops import attention_block as fab
from construction_clip_tpu_torch.ops import flash_attention as fa
from construction_clip_tpu_torch.parallel.infonce import local_infonce
from construction_clip_tpu_torch.train import checkpoint, contrastive, state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# vision T = (34/2)^2 + 1 = 290 > 256: the image tower takes flash attention
LONG_T = CLIPConfig(
    vision=VisionConfig(image_size=34, patch_size=2, width=32, layers=1, heads=2, embed_dim=16),
    text=TextConfig(vocab_size=64, context_length=8, width=32, layers=1, heads=2, embed_dim=16))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=path)


def _opt_case(seed):
    gen = np.random.default_rng(seed)
    params = {"a": {"w": gen.standard_normal((4, 3)).astype(np.float32)},
              "b": gen.standard_normal(5).astype(np.float32)}
    grads = [jax.tree.map(lambda p: gen.standard_normal(p.shape).astype(np.float32), params)
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize("kind", ["fused", "clip", "decay"])
def test_adamw_matches_jax_over_5_steps(kind):
    """fused_adamw (update_and_apply) and make_adamw's clip chain (update, then
    add), against the JAX package's optimizers on the same gradients. fp32: the
    same per-element arithmetic, bias corrections in double here and in fp32
    there (relative 1e-7)."""
    params, grads = _opt_case(0)
    kw = dict(warmup_steps=2, total_steps=10)
    if kind == "clip":
        kw["grad_clip"] = 1.0
    if kind == "decay":
        kw["weight_decay"] = 0.1
    jtx, ttx = jstate.make_adamw(1e-2, **kw), state.make_adamw(1e-2, **kw)
    jst = jstate.TrainState.create(jax.tree.map(jnp.asarray, params), jtx)
    tst = state.TrainState.create(convert.to_params(params, trainable=True), ttx)
    assert hasattr(ttx, "update_and_apply") == hasattr(jtx, "update_and_apply")
    for g in grads:
        jst = jstate.apply_gradients(jst, jax.tree.map(jnp.asarray, g), jtx)
        tst = state.apply_gradients(tst, convert.to_params(g).tree(), ttx)
        _tree_close(as_tree(tst.params), _np_tree(jst.params), rtol=1e-6, atol=1e-7)
    assert tst.step == int(jst.step) == 5


def test_schedule_matches_jax():
    jsched = jstate.linear_warmup_schedule(1e-3, 10, 50)
    tsched = state.linear_warmup_schedule(1e-3, 10, 50)
    for step in (0, 1, 5, 9, 10, 11, 30, 49, 50, 60):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6, atol=1e-12)


def test_local_infonce_matches_jax():
    gen = np.random.default_rng(1)
    img, txt = (gen.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    scale = np.float32(2.6592)
    jloss, jlogits = jinfonce.local_infonce(jnp.asarray(img), jnp.asarray(txt), scale)
    tloss, tlogits = local_infonce(torch.from_numpy(img), torch.from_numpy(txt),
                                   torch.tensor(scale))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


@pytest.fixture
def jax_pallas(monkeypatch):
    """The JAX package on its kernel path: Pallas in interpret mode."""
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(jattention, "_IMPL", "pallas")


def _batch(cfg, b, seed):
    gen = np.random.default_rng(seed)
    v = cfg.vision
    images = gen.standard_normal((b, v.image_size, v.image_size, 3)).astype(np.float32)
    tokens = gen.integers(1, cfg.text.vocab_size, (b, cfg.text.context_length),
                          dtype=np.int32)
    return images, tokens


@pytest.mark.parametrize("name", ["tiny", "long_t"])
def test_train_steps_match_jax(name, jax_pallas):
    """3 steps of make_train_step from the same params and batches against the
    JAX package's step on a 1-device mesh, fp32 on both sides. Loss to 1e-5
    relative and accuracy exactly: the forward differs by summation order
    (~1e-7). Updated params to 2e-6 absolute: AdamW turns each gradient into an
    update of at most about lr = 1e-4 per step, carrying the gradient's
    relative error (~1e-6). The key bias is the exception: its gradient is
    mathematically zero (softmax does not change when every logit of a row
    moves by q.b_k), so on both sides Adam normalises rounding noise of
    arbitrary sign into updates of up to lr, and the two sides may move apart
    by 2 lr per step; it is held only to that bound."""
    cfg = CLIPConfig.tiny() if name == "tiny" else LONG_T
    jcfg = JCLIPConfig(**{f: getattr(cfg, f) for f in ("quick_gelu", "logit_scale_init")},
                       vision=cfg.vision, text=cfg.text)
    jparams = init_clip(jax.random.key(3), jcfg)
    kw = dict(warmup_steps=0, total_steps=100)
    jtx, ttx = jstate.make_adamw(1e-4, **kw), state.make_adamw(1e-4, **kw)
    mesh = create_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, devices=jax.devices()[:1])
    jstep = jcontrastive.make_train_step(jcfg, jtx, mesh)
    tstep = contrastive.make_train_step(cfg, ttx)
    jst = jstate.TrainState.create(jparams, jtx)
    tst = state.TrainState.create(convert.to_params(jparams, trainable=True), ttx)
    for i in range(3):
        images, tokens = _batch(cfg, 4, 10 + i)
        jst, jm = jstep(jst, {"images": jnp.asarray(images), "tokens": jnp.asarray(tokens)})
        tst, tm = tstep(tst, {"images": torch.from_numpy(images),
                              "tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    got, want = as_tree(tst.params), _np_tree(jst.params)
    for tower in ("vision", "text"):
        d = want[tower]["blocks"]["attn"]["b_qkv"].shape[-1] // 3
        for part, atol in (((0, d), 2e-6), ((d, 2 * d), 2 * 3 * 1e-4), ((2 * d, 3 * d), 2e-6)):
            np.testing.assert_allclose(
                got[tower]["blocks"]["attn"]["b_qkv"][..., slice(*part)].detach().numpy(),
                want[tower]["blocks"]["attn"]["b_qkv"][..., slice(*part)], rtol=0, atol=atol)
        want[tower]["blocks"]["attn"].pop("b_qkv")
    _tree_close(got, want, rtol=0, atol=2e-6)
    assert tst.step == int(jst.step) == 3


def test_clip_forward_and_eval_step_match_jax():
    from construction_clip_tpu.models.clip import clip_forward as jclip_forward

    from construction_clip_tpu_torch.models.clip.model import clip_forward

    cfg = CLIPConfig.tiny()
    jparams = init_clip(jax.random.key(4), JCLIPConfig.tiny())
    params = convert.to_params(jparams)
    images, tokens = _batch(cfg, 5, 1)
    want = jclip_forward(jparams, JCLIPConfig.tiny(), jnp.asarray(images), jnp.asarray(tokens))
    got = clip_forward(params.tree(), cfg, torch.from_numpy(images), torch.from_numpy(tokens))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    mesh = create_mesh({DATA_AXIS: 1, MODEL_AXIS: 1}, devices=jax.devices()[:1])
    jacc = jcontrastive.make_eval_step(JCLIPConfig.tiny(), mesh)(
        jparams, {"images": jnp.asarray(images), "tokens": jnp.asarray(tokens)})
    tacc = contrastive.make_eval_step(cfg)(
        params, {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)})
    assert float(tacc) == float(jacc)


def test_long_t_config_takes_flash_attention(monkeypatch):
    """The long-T config's image tower runs flash attention (T=290), its text
    tower the fused block, in the forward and the backward of a train step."""
    calls = []
    for mod, name in ((fab, "fused_attention_block_bwd"), (fa, "flash_attention_bwd")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n),
                                                                           _o(*a, **k))[1])
    params = convert.to_params(convert.init_clip(0, LONG_T), trainable=True)
    tx = state.make_adamw(1e-4, warmup_steps=0)
    images, tokens = _batch(LONG_T, 2, 0)
    contrastive.make_train_step(LONG_T, tx)(
        state.TrainState.create(params, tx),
        {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)})
    assert sorted(set(calls)) == ["flash_attention_bwd", "fused_attention_block_bwd"]


def test_npz_is_read_by_the_jax_package(tmp_path):
    cfg = CLIPConfig.tiny()
    params = convert.to_params(convert.init_clip(5, cfg))
    path = str(tmp_path / "clip_latest.npz")
    checkpoint.save_params_npz(path, params)
    template = init_clip(jax.random.key(0), JCLIPConfig.tiny())
    loaded = jckpt.load_params_npz(path, template)
    _tree_close(as_tree(params), _np_tree(loaded), rtol=0, atol=0)
    back = checkpoint.load_params_npz(path, convert.init_clip(convert.SHAPES, cfg))
    _tree_close(convert.to_params(back).tree(), _np_tree(loaded), rtol=0, atol=0)


def test_state_checkpoint_roundtrip(tmp_path):
    cfg = CLIPConfig.tiny()
    tx = state.make_adamw(1e-3, warmup_steps=0)
    step = contrastive.make_train_step(cfg, tx)
    images, tokens = _batch(cfg, 2, 0)
    batch = {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}
    st, _ = step(state.TrainState.create(
        convert.to_params(convert.init_clip(0, cfg), trainable=True), tx), batch)
    checkpoint.save_state(str(tmp_path), st)
    fresh = state.TrainState.create(
        convert.to_params(convert.init_clip(1, cfg), trainable=True), tx)
    restored = checkpoint.restore_state(str(tmp_path), fresh)
    assert restored.step == 1 and checkpoint.latest_step(str(tmp_path)) == 1
    _tree_close(as_tree(restored.params), jax.tree.map(
        lambda t: t.detach().numpy(), as_tree(st.params)), rtol=0, atol=0)
    a, _ = step(st, batch)
    b, _ = step(restored, batch)
    _tree_close(as_tree(b.params), jax.tree.map(lambda t: t.detach().numpy(),
                                                as_tree(a.params)), rtol=0, atol=0)


def _resilient_run(directory, fail_at=None, interrupt_at=None):
    """run_resilient over 2 epochs of 2 tiny train steps each. `fail_at` /
    `interrupt_at` = (epoch, step): the first time there, one more train step
    is taken (moving the params and moments in place) and then the epoch
    raises RuntimeError / KeyboardInterrupt. Returns the final state."""
    from construction_clip_tpu_torch.train.resilience import run_resilient

    cfg = CLIPConfig.tiny()
    tx = state.make_adamw(1e-3, warmup_steps=1, total_steps=4)
    step = contrastive.make_train_step(cfg, tx)
    batches = [_batch(cfg, 2, 20 + i) for i in range(2)]
    pending = {"fail": fail_at, "interrupt": interrupt_at}

    def train_epoch(st, epoch):
        for i, (images, tokens) in enumerate(batches):
            batch = {"images": torch.from_numpy(images), "tokens": torch.from_numpy(tokens)}
            st, _ = step(st, batch)
            for kind, exc in (("fail", RuntimeError), ("interrupt", KeyboardInterrupt)):
                if pending[kind] == (epoch, i):
                    pending[kind] = None
                    step(st, batch)
                    raise exc(f"{kind} at epoch {epoch} step {i}")
        return st

    st = state.TrainState.create(
        convert.to_params(convert.init_clip(0, cfg), trainable=True), tx)
    return run_resilient(train_epoch, st, epochs=2, checkpoint_dir=str(directory),
                         save_every_epochs=1)


def _same_state(got, want):
    assert got.step == want.step == 4
    _tree_close(as_tree(got.params), jax.tree.map(lambda t: t.detach().numpy(),
                                                  as_tree(want.params)), rtol=0, atol=0)
    assert int(got.opt_state["count"]) == int(want.opt_state["count"])


@pytest.mark.parametrize("fail_at", [(0, 0), (1, 1)], ids=["before_first_save", "later"])
def test_run_resilient_retries_from_a_whole_epoch(tmp_path, fail_at):
    """An epoch that fails after it has moved the params in place is retried
    from the last epoch boundary (the initial state before any periodic
    save), and the run ends where a run without the failure ends."""
    want = _resilient_run(tmp_path / "clean")
    got = _resilient_run(tmp_path / "failed", fail_at=fail_at)
    _same_state(got, want)


def test_run_resilient_interrupt_saves_no_partial_epoch(tmp_path):
    """A KeyboardInterrupt in the middle of an epoch saves nothing under that
    epoch's name; the rerun resumes from the last whole epoch and ends where a
    run without the interrupt ends."""
    want = _resilient_run(tmp_path / "clean")
    with pytest.raises(KeyboardInterrupt):
        _resilient_run(tmp_path / "run", interrupt_at=(1, 0))
    assert checkpoint.latest_step(str(tmp_path / "run")) == 1
    _same_state(_resilient_run(tmp_path / "run"), want)


def _corpus(tmp_path):
    from PIL import Image

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_offline_assets

    gen = np.random.default_rng(4)
    vts = ["墜落", "機械", "物料"]
    anns = []
    for i in range(9):
        fn = f"im{i}.jpg"
        Image.fromarray((gen.random((40, 48, 3)) * 255).astype(np.uint8)).save(tmp_path / fn)
        anns.append({"id": i, "caption_type": "violation", "violation_type": vts[i % 3],
                     "violation_list": f"x{i}", "caption": "", "file_name": fn,
                     "objects": ""})
    (tmp_path / "all.json").write_text(
        json.dumps({"type": "captions", "annotations": anns}, ensure_ascii=False),
        encoding="utf-8")
    make_offline_assets.write_clip_merges(str(tmp_path / "merges.txt.gz"), n_merges=6)


def test_cli_trains_resumes_and_writes_npz(tmp_path, capsys, monkeypatch):
    """Two runs of the training CLI's main (`python -m
    construction_clip_tpu_torch.apps.train_clip`): one epoch, then two epochs
    resuming from the first's checkpoint; the final npz loads into the JAX
    package. TensorBoard is made unimportable, so the metric logger writes its
    JSONL only (importing it pulls in TensorFlow where that is installed)."""
    from construction_clip_tpu_torch.apps import train_clip

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    _corpus(tmp_path)
    common = ["--json_path", str(tmp_path / "all.json"), "--image_path", str(tmp_path),
              "--arch", "tiny_bpe", "--precision", "fp32",
              "--clip_bpe", str(tmp_path / "merges.txt.gz"), "--combination_num", "3",
              "--save_every", "1", "--output_dir", str(tmp_path / "m"),
              "--log_dir", str(tmp_path / "log"), "--warmup_steps", "0",
              "--groups_per_batch", "5", "--device", "cpu"]
    train_clip.main(common + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert "loss" in out and "saved inference params" in out
    train_clip.main(common + ["--epochs", "2"])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "m" / "clip_comb3")) == [
        "step_0.pt", "step_1.pt", "step_2.pt"]
    logs = [json.loads(line) for line in open(tmp_path / "log" / "clip_comb3.jsonl")]
    assert max(r["step"] for r in logs) == 20   # 50 groups, 5 a step, 2 epochs
    template = init_clip(jax.random.key(0), JCLIPConfig.tiny_bpe())
    loaded = jckpt.load_params_npz(str(tmp_path / "m" / "clip_latest.npz"), template)
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(loaded))


def test_caption_cli_trains_two_steps_and_its_checkpoint_loads(tmp_path, capsys, monkeypatch):
    """train_clip_caption's main on plain (image, violation_list) pairs: 7 train
    pairs of 9 (train_ratio 0.8), 3 a step, so one epoch is 2 steps of
    train_clip's loop; its epoch checkpoint restores and its npz loads into
    the JAX package."""
    from construction_clip_tpu_torch.apps import train_clip_caption
    from construction_clip_tpu_torch.train.state import TrainState, make_adamw

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    _corpus(tmp_path)
    args = ["--json_path", str(tmp_path / "all.json"), "--image_path", str(tmp_path),
            "--arch", "tiny_bpe", "--precision", "fp32",
            "--clip_bpe", str(tmp_path / "merges.txt.gz"), "--batch_size", "3",
            "--epochs", "1", "--save_every", "1", "--output_dir", str(tmp_path / "m"),
            "--log_dir", str(tmp_path / "log"), "--warmup_steps", "0", "--device", "cpu"]
    assert train_clip_caption.parse_args([]).key == "violation_list"
    train_clip_caption.main(args)
    assert "saved inference params" in capsys.readouterr().out
    logs = [json.loads(line) for line in open(tmp_path / "log" / "clip_cap.jsonl")]
    losses = [r for r in logs if "loss" in r]
    assert losses[-1]["step"] == 2 and np.isfinite(losses[-1]["loss"])
    assert "test_accuracy" in logs[-1]   # the save_every epoch's evaluation
    assert sorted(os.listdir(tmp_path / "m" / "clip_cap")) == ["step_0.pt", "step_1.pt"]
    tree = convert.to_params(convert.init_clip(0, CLIPConfig.tiny_bpe()), trainable=True)
    tx = make_adamw(1e-5, warmup_steps=0, total_steps=2)
    restored = checkpoint.restore_state(str(tmp_path / "m" / "clip_cap"),
                                        TrainState.create(tree, tx))
    assert restored.step == 2
    template = init_clip(jax.random.key(0), JCLIPConfig.tiny_bpe())
    loaded = jckpt.load_params_npz(str(tmp_path / "m" / "clip_cap_latest.npz"), template)
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree.leaves(loaded))
    # --native_loader: the same run through the C++ JPEG ingest, which builds
    # wherever the JAX binding does
    from construction_clip_tpu.data import native_loader as j_native
    from construction_clip_tpu_torch.data import native_loader

    native = [a if a != str(tmp_path / "m") else str(tmp_path / "m_native") for a in args]
    train_clip_caption.main(native + ["--native_loader"])
    assert native_loader.native_available() or not j_native.native_available()
    assert "saved inference params" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "m_native" / "clip_cap")) == ["step_0.pt", "step_1.pt"]


def test_train_clip_cli_runs_with_the_native_loader(tmp_path, capsys, monkeypatch):
    """train_clip --native_loader runs an epoch, through the port's C++ ingest
    wherever the JAX binding builds (and through its PIL fallback elsewhere)."""
    from construction_clip_tpu.data import native_loader as j_native
    from construction_clip_tpu_torch.apps import train_clip
    from construction_clip_tpu_torch.data import native_loader

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    _corpus(tmp_path)
    train_clip.main(["--json_path", str(tmp_path / "all.json"), "--image_path", str(tmp_path),
                     "--arch", "tiny_bpe", "--precision", "fp32",
                     "--clip_bpe", str(tmp_path / "merges.txt.gz"), "--combination_num", "3",
                     "--save_every", "1", "--output_dir", str(tmp_path / "m"),
                     "--log_dir", str(tmp_path / "log"), "--warmup_steps", "0",
                     "--groups_per_batch", "25", "--epochs", "1", "--device", "cpu",
                     "--native_loader"])
    assert "saved inference params" in capsys.readouterr().out
    logs = [json.loads(line) for line in open(tmp_path / "log" / "clip_comb3.jsonl")]
    assert max(r["step"] for r in logs) == 2   # 50 groups, 25 a step
    assert native_loader.native_available() or not j_native.native_available()


def test_native_loader_trains_clip_and_its_batches_are_the_jax_loaders(tmp_path):
    """The loader train_clip --native_loader builds (TorchImageTextLoader with
    the port's C++ ingest as load_image) gives the batches of the JAX
    package's ImageTextLoader with the JAX binding's hook. Skips where the
    JAX binding has no library, as its needs_native tests do: there both
    sides would fall back to PIL."""
    from construction_clip_tpu.data import native_loader as j_native
    from construction_clip_tpu.data import pipeline as j_pipeline
    from construction_clip_tpu_torch.data import native_loader
    from construction_clip_tpu_torch.data.datasets import PairGroupDataset
    from construction_clip_tpu_torch.data.loader import TorchImageTextLoader

    if not j_native.native_available():
        pytest.skip("native lib unavailable (no g++/libjpeg)")
    assert native_loader.native_available()
    _corpus(tmp_path)
    ds = PairGroupDataset(str(tmp_path / "all.json"), combination_num=3)

    def tokenize(texts):
        return np.array([[len(t)] for t in texts], np.int32)

    def hook(module):
        load = module.make_native_loader(256)
        return lambda f: load(os.path.join(str(tmp_path), f))

    port = TorchImageTextLoader(ds, tokenize, batch_size=5, load_image=hook(native_loader))
    orig = j_pipeline.ImageTextLoader(ds, tokenize, batch_size=5, load_image=hook(j_native))
    got, want = list(itertools.islice(port, 2)), list(itertools.islice(orig, 2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["images"].shape == (15, 256, 256, 3)
        for key in ("images", "tokens"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
