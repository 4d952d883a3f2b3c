"""PyTorch port, data-parallel contrastive training against the JAX package:
the feature all-gather's plain version, `global_infonce` against JAX's under
shard_map on 4 of the 8 virtual CPU devices, the 4-rank `loss_and_grads`
against `jax.grad` of the full-batch loss, 3 AdamW steps against JAX's
4-device `make_train_step`, the loader's shards, the training app under 2
ranks, and the repairs of the apps' precision and of `load_params_npz`.

The ranks are processes spawned by core/mesh.spawn_ranks (gloo, a file
rendezvous, at most 60 s a group). Each imports this module, which imports
no JAX at its top: the tests import it where they need it."""

import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core import tracing
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.mesh import replicate, shard_batch, spawn_ranks
from construction_clip_tpu_torch.core.params import as_tree, tree_map
from construction_clip_tpu_torch.data.loader import TorchImageTextLoader
from construction_clip_tpu_torch.data.pipeline import ImageTextLoader
from construction_clip_tpu_torch.ops import collectives
from construction_clip_tpu_torch.parallel.infonce import global_infonce
from construction_clip_tpu_torch.train import checkpoint, contrastive, state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GLOBAL_B = 8    # 2 rows a rank


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), as_tree(tree))


def _tree_close(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        for k in want:
            _tree_close(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=path)


def _leaf_scaled_close(got, want, tol, path=""):
    """Every leaf within `tol` of that leaf's largest element."""
    if isinstance(want, dict):
        for k in want:
            _leaf_scaled_close(got[k], want[k], tol, f"{path}/{k}")
        return
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=path)


def _rank_rows(shape, rank, dtype):
    return torch.from_numpy(np.random.default_rng(rank).standard_normal(shape).astype(
        np.float32)).to(dtype)


# ---- what each spawned rank runs -------------------------------------------------------

def _gather_rank(dp, shape, dtype):
    got = collectives.all_gather(_rank_rows(shape, dp.rank, dtype), dp)
    return got.float().numpy(), tracing.counters().get("k10", 0)


def _dp_rank(dp, case):
    """The port's side of every 4-rank comparison, on this rank's rows."""
    cfg = CLIPConfig.tiny()
    out = {}
    feats = shard_batch(dp, {"img": torch.from_numpy(case["img"]),
                             "txt": torch.from_numpy(case["txt"])})
    img, txt = (feats[k].clone().requires_grad_() for k in ("img", "txt"))
    loss, acc = global_infonce(img, txt, torch.tensor(case["scale"]), dp)
    g_img, g_txt = torch.autograd.grad(loss, [img, txt])
    out["infonce"] = (float(loss.detach()), float(acc), g_img.numpy(), g_txt.numpy())

    def rows(i):
        images, tokens = case["batches"][i]
        return shard_batch(dp, {"images": torch.from_numpy(images),
                                "tokens": torch.from_numpy(tokens)})

    params = convert.to_params(case["params"], trainable=True)
    loss, acc, grads = contrastive.loss_and_grads(
        params, cfg, rows(0)["images"], rows(0)["tokens"], dp=dp)
    out["grads"] = (float(loss), float(acc), _np(grads))

    tx = state.make_adamw(1e-4, warmup_steps=0, total_steps=100)
    params = convert.to_params(case["params"], trainable=True)
    if dp.rank:   # every rank starts from rank 0's params
        with torch.no_grad():
            for p in params.parameters():
                p.add_(1.0)
    st = state.TrainState.create(replicate(dp, params), tx)
    step = contrastive.make_train_step(cfg, tx, dp=dp)
    metrics = []
    for i in range(len(case["batches"])):
        st, m = step(st, rows(i))
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    out["steps"] = (metrics, _np(st.params))
    out["eval"] = float(contrastive.make_eval_step(cfg, dp=dp)(st.params, rows(0)))
    return out


def _close_rank(dp, marker):
    """Rank 1 lingers after its work, then leaves `marker`; rank 0 records, at
    the moment it destroys its process group, whether the marker is there,
    that is whether rank 1 had finished its work and reached `close`."""
    seen = {}
    if dp.rank == 0:
        destroy = torch.distributed.destroy_process_group

        def recording_destroy(*args, **kwargs):
            seen["peer_reached_close"] = os.path.exists(marker)
            return destroy(*args, **kwargs)

        torch.distributed.destroy_process_group = recording_destroy
    else:
        time.sleep(1.0)
        with open(marker, "w"):
            pass
    return seen   # filled in by close, before the result is sent


def _app_rank(dp, argv):
    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        sys.modules[mod] = None   # the metric logger writes its JSONL only
    from construction_clip_tpu_torch.apps import train_clip

    train_clip.train(train_clip.parse_args(argv), dp)


# ---- the process group ------------------------------------------------------------------

def test_close_waits_for_every_rank_before_destroying_the_group(tmp_path):
    """DataParallel.close meets every rank before it destroys the group: a
    rank that finished first would otherwise tear its gloo connections down
    while a peer is still working, or still inside gloo's full-mesh
    handshake, which fails that peer with "connection closed by peer"."""
    results = spawn_ranks(_close_rank, 2, (str(tmp_path / "rank1_done"),), device="cpu",
                          timeout=60)
    assert results == [{"peer_reached_close": True}, {}]


class _CudaStarted(Exception):
    pass


def test_init_data_parallel_loads_modules_eagerly_before_cuda_starts(monkeypatch):
    """On a CUDA device, init_data_parallel asks for eager module loading
    before its first CUDA call, as K10's deadline needs (checked with a
    stand-in for torch.cuda.set_device, so no card is needed)."""
    from construction_clip_tpu_torch.core import mesh

    seen = []

    def set_device(device):
        seen.append(os.environ.get("CUDA_MODULE_LOADING"))
        raise _CudaStarted

    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    with pytest.raises(_CudaStarted):
        mesh.init_data_parallel(rank=0, world=1, device="cuda:0")
    assert seen == ["EAGER"]


def test_training_app_loads_modules_eagerly_before_cuda_starts(monkeypatch):
    """The training app's ranks (--device cuda) ask for eager module loading
    before resolve_device's first CUDA call; on the CPU they leave it alone."""
    from construction_clip_tpu_torch.apps import train_clip
    from construction_clip_tpu_torch.core import mesh

    seen = []

    def resolve(flag):
        seen.append(os.environ.get("CUDA_MODULE_LOADING"))
        return torch.device("cpu")

    monkeypatch.delenv("CUDA_MODULE_LOADING", raising=False)
    monkeypatch.setattr(train_clip, "resolve_device", resolve)
    monkeypatch.setattr(mesh, "init_data_parallel", lambda device: device)
    assert train_clip.join_world("cpu", 2) == torch.device("cpu")
    assert train_clip.join_world("cuda", 2) == torch.device("cpu")
    assert seen == [None, "EAGER"]


# ---- the gather --------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_plain_gather_is_the_concatenation(world):
    """On the CPU all_gather runs its plain version (gloo, then torch.cat) and
    launches nothing; rank p's rows land at p * chunk, on every rank."""
    shape = (3, 5)
    results = spawn_ranks(_gather_rank, world, (shape, torch.float32), device="cpu",
                          timeout=60)
    want = torch.cat([_rank_rows(shape, r, torch.float32) for r in range(world)]).numpy()
    for got, launches in results:
        np.testing.assert_array_equal(got, want)
        assert launches == 0


# ---- 4 ranks against the JAX package ------------------------------------------------------

@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
    from construction_clip_tpu.core.mesh import DATA_AXIS, MODEL_AXIS, create_mesh
    from construction_clip_tpu.models.clip import encode_image, encode_text, init_clip
    from construction_clip_tpu.parallel import infonce as jinfonce
    from construction_clip_tpu.train import checkpoint as jckpt
    from construction_clip_tpu.train import contrastive as jcontrastive
    from construction_clip_tpu.train import state as jstate

    mesh = create_mesh({DATA_AXIS: WORLD, MODEL_AXIS: 1}, devices=jax.devices()[:WORLD])
    return types.SimpleNamespace(**locals())


@pytest.fixture(scope="module")
def case(jx):
    gen = np.random.default_rng(7)
    img, txt = (gen.standard_normal((GLOBAL_B, 16)).astype(np.float32) for _ in range(2))
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    cfg = CLIPConfig.tiny()
    batches = []
    for _ in range(3):
        images = gen.standard_normal((GLOBAL_B, 32, 32, 3)).astype(np.float32)
        tokens = gen.integers(1, cfg.text.vocab_size, (GLOBAL_B, cfg.text.context_length),
                              dtype=np.int32)
        batches.append((images, tokens))
    params = jx.jax.tree.map(lambda a: np.asarray(a, np.float32),
                             jx.init_clip(jx.jax.random.key(3), jx.JCLIPConfig.tiny()))
    return {"img": img, "txt": txt, "scale": np.float32(2.6592), "batches": batches,
            "params": params}


@pytest.fixture(scope="module")
def dp4(case):
    """The port's results on each of 4 ranks (one spawned group for all the
    comparisons below)."""
    return spawn_ranks(_dp_rank, WORLD, (case,), device="cpu", timeout=60)


def test_global_infonce_matches_jax(jx, case, dp4):
    """Loss and accuracy to 1e-6 relative (one fp32 product and a log-sum-exp
    in another order), on every rank."""
    def f(img, txt, scale):
        return jx.jinfonce.global_infonce(img, txt, scale)

    sm = jx.jax.shard_map(f, mesh=jx.mesh, in_specs=(jx.P(jx.DATA_AXIS), jx.P(jx.DATA_AXIS),
                                                     jx.P()),
                          out_specs=(jx.P(), jx.P()), check_vma=False)
    loss, acc = jx.jax.jit(sm)(case["img"], case["txt"], case["scale"])
    for rank in dp4:
        np.testing.assert_allclose(rank["infonce"][0], float(loss), rtol=1e-6)
        assert rank["infonce"][1] == float(acc)


def test_global_infonce_gradients_match_jax(jx, case, dp4):
    """Each rank's gradient with respect to its own feature rows: the
    psum_scatter of the gathered columns' gradients plus the local rows'
    own, against jax.grad inside shard_map; to 1e-6 of the largest element
    (fp32 sums in another order)."""
    def f(img, txt, scale):
        return jx.jax.grad(lambda i, t: jx.jinfonce.global_infonce(i, t, scale)[0],
                           argnums=(0, 1))(img, txt)

    spec = jx.P(jx.DATA_AXIS)
    sm = jx.jax.shard_map(f, mesh=jx.mesh, in_specs=(spec, spec, jx.P()),
                          out_specs=(spec, spec), check_vma=False)
    g_img, g_txt = jx.jax.jit(sm)(case["img"], case["txt"], case["scale"])
    _leaf_scaled_close(np.concatenate([r["infonce"][2] for r in dp4]), g_img, 1e-6)
    _leaf_scaled_close(np.concatenate([r["infonce"][3] for r in dp4]), g_txt, 1e-6)


def test_dp4_loss_and_grads_match_the_full_batch_gradient(jx, case, dp4):
    """The 4-rank loss_and_grads (global InfoNCE, the gradients all-reduced
    and divided by 4) against jax.grad of the JAX package's full-batch
    local_infonce loss on the same 8 rows: the loss to 1e-5 relative, every
    leaf to 1e-5 of its largest element (four partial sums in another
    order), and every rank's gradients the same."""
    images, tokens = case["batches"][0]
    jcfg = jx.JCLIPConfig.tiny()

    def full_loss(params):
        img_f = jx.encode_image(params, jcfg, images, normalize=True)
        txt_f = jx.encode_text(params, jcfg, tokens, normalize=True)
        return jx.jinfonce.local_infonce(img_f, txt_f, params["logit_scale"])[0]

    loss, grads = jx.jax.value_and_grad(full_loss)(
        jx.jax.tree.map(jx.jnp.asarray, case["params"]))
    want = jx.jax.tree.map(np.asarray, grads)
    for rank in dp4:
        np.testing.assert_allclose(rank["grads"][0], float(loss), rtol=1e-5)
        _leaf_scaled_close(rank["grads"][2], want, 1e-5)
        _tree_close(rank["grads"][2], dp4[0]["grads"][2], rtol=0, atol=0)


def _noise_aware_close(got, want, grads, path=""):
    """Params to 2e-6 absolute, except elements whose step-1 gradient lies
    below 1e-6 of its leaf's largest, the level of fp32 rounding in sums of
    another order: there Adam normalises noise of arbitrary sign into updates
    of up to lr = 1e-4 a step on each side, so the two sides may move apart
    by 2 lr a step. The key bias is such a leaf part (its gradient is
    mathematically zero: softmax does not change when every logit of a row
    moves by q.b_k), and so is the key weight along an input direction the
    tokens share."""
    if isinstance(want, dict):
        for k in want:
            _noise_aware_close(got[k], want[k], grads[k], f"{path}/{k}")
        return
    g = np.abs(np.asarray(grads))
    atol = np.where(g < 1e-6 * g.max(), 2 * 3 * 1e-4, 2e-6)
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert (err <= atol).all(), (path, float(err.max()), float((err - atol).max()))


def test_dp4_train_steps_match_jax(jx, case, dp4):
    """3 AdamW steps of the 4-rank make_train_step (from rank 0's params,
    broadcast over ranks that started elsewhere) against the JAX package's
    make_train_step on a 4-device mesh, at test_train_steps_match_jax's
    tolerances: the loss to 1e-5 relative, the accuracy exactly, the params
    to 2e-6 absolute except where the gradient is rounding noise
    (`_noise_aware_close`), and every rank's replica the same."""
    kw = dict(warmup_steps=0, total_steps=100)
    jtx = jx.jstate.make_adamw(1e-4, **kw)
    jcfg = jx.JCLIPConfig.tiny()
    jstep = jx.jcontrastive.make_train_step(jcfg, jtx, jx.mesh)
    jst = jx.jstate.TrainState.create(jx.jax.tree.map(jx.jnp.asarray, case["params"]), jtx)
    for i, (images, tokens) in enumerate(case["batches"]):
        jst, jm = jstep(jst, {"images": jx.jnp.asarray(images), "tokens": jx.jnp.asarray(tokens)})
        for rank in dp4:
            loss, acc = rank["steps"][0][i]
            np.testing.assert_allclose(loss, float(jm["loss"]), rtol=1e-5)
            assert acc == float(jm["accuracy"])
    want = jx.jax.tree.map(lambda a: np.asarray(a, np.float32), jst.params)
    _noise_aware_close(dp4[0]["steps"][1], want, dp4[0]["grads"][2])
    for rank in dp4[1:]:
        _tree_close(rank["steps"][1], dp4[0]["steps"][1], rtol=0, atol=0)


def test_dp4_eval_scores_the_global_batch(jx, case, dp4):
    """make_eval_step under 4 ranks gathers both features and scores the
    whole batch, as the JAX package's eval scores a batch-sharded input: the
    same accuracy as the JAX eval on the 8 rows, with the params after the 3
    steps, on every rank."""
    images, tokens = case["batches"][0]
    jeval = jx.jcontrastive.make_eval_step(jx.JCLIPConfig.tiny(), jx.mesh)
    params = jx.jax.tree.map(jx.jnp.asarray, dp4[0]["steps"][1])
    want = float(jeval(params, {"images": jx.jnp.asarray(images),
                                "tokens": jx.jnp.asarray(tokens)}))
    assert [rank["eval"] for rank in dp4] == [want] * WORLD


# ---- the loader --------------------------------------------------------------------------

class _Groups:
    """Items of 3 (file, text) rows, as PairGroupDataset's groups."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return [f"{i}_{j}" for j in range(3)], [f"t{i}{j}" for j in range(3)]


def _image(name):
    i, j = map(int, name.split("_"))
    return np.full((20 + i, 30 + j, 3), 7 * i + j, np.uint8)


def _tokenize(texts):
    return np.array([[ord(c) for c in t.ljust(4)] for t in texts], np.int32)


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_shards_make_the_global_batch(world):
    """Every rank draws the same order and decodes only its own rows: the
    ranks' batches, in rank order, are the host loader's batches (the copy of
    the JAX package's ImageTextLoader), for two epochs (the order reshuffles
    per epoch). World 1 is the loader without `dp`."""
    kw = dict(batch_size=2, load_image=_image, image_size=8, num_threads=2)
    whole = ImageTextLoader(_Groups(), _tokenize, **kw)
    if world == 1:
        ranks = [TorchImageTextLoader(_Groups(), _tokenize, **kw)]
    else:
        ranks = [TorchImageTextLoader(_Groups(), _tokenize, **kw, dp=types.SimpleNamespace(
            rank=r, world=world, device=torch.device("cpu"))) for r in range(world)]
    for _ in range(2):
        want = list(whole)
        shards = [list(loader) for loader in ranks]
        assert len(want) == 5 and all(len(s) == 5 for s in shards)
        for i, batch in enumerate(want):
            for key in ("images", "tokens"):
                got = torch.cat([s[i][key] for s in shards])
                assert all(s[i][key].shape[0] == 6 // world for s in shards)
                np.testing.assert_array_equal(got.numpy(), batch[key])


# ---- the training app ----------------------------------------------------------------------

def _corpus(root):
    from PIL import Image

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_offline_assets

    gen = np.random.default_rng(4)
    vts = ["墜落", "機械", "物料"]
    anns = []
    for i in range(9):
        fn = f"im{i}.jpg"
        Image.fromarray((gen.random((40, 48, 3)) * 255).astype(np.uint8)).save(root / fn)
        anns.append({"id": i, "caption_type": "violation", "violation_type": vts[i % 3],
                     "violation_list": f"x{i}", "caption": "", "file_name": fn,
                     "objects": ""})
    (root / "all.json").write_text(
        json.dumps({"type": "captions", "annotations": anns}, ensure_ascii=False),
        encoding="utf-8")
    make_offline_assets.write_clip_merges(str(root / "merges.txt.gz"), n_merges=6)


def _app_argv(root, groups=4):
    return ["--json_path", str(root / "all.json"), "--image_path", str(root),
            "--arch", "tiny_bpe", "--precision", "fp32",
            "--clip_bpe", str(root / "merges.txt.gz"), "--combination_num", "3",
            "--save_every", "1", "--output_dir", str(root / "m"),
            "--log_dir", str(root / "log"), "--warmup_steps", "0",
            "--groups_per_batch", str(groups), "--device", "cpu", "--epochs", "1"]


def test_app_trains_under_two_ranks(tmp_path, jx):
    """The training app under 2 spawned ranks on a PIL-written corpus: one
    epoch of 12 steps of 12 rows (6 a rank), rank 0 alone logging and writing
    the epoch checkpoints and one .npz, which the JAX package reads."""
    _corpus(tmp_path)
    spawn_ranks(_app_rank, 2, (_app_argv(tmp_path),), device="cpu", timeout=60)
    assert sorted(os.listdir(tmp_path / "m" / "clip_comb3")) == ["step_0.pt", "step_1.pt"]
    logs = [json.loads(line) for line in open(tmp_path / "log" / "clip_comb3.jsonl")]
    assert max(r["step"] for r in logs) == 12   # 50 groups, 4 a step
    assert all(np.isfinite(r["loss"]) for r in logs if "loss" in r)
    template = jx.init_clip(jx.jax.random.key(0), jx.JCLIPConfig.tiny_bpe())
    loaded = jx.jckpt.load_params_npz(str(tmp_path / "m" / "clip_latest.npz"), template)
    assert all(np.isfinite(np.asarray(a)).all() for a in jx.jax.tree.leaves(loaded))


def test_app_refuses_more_ranks_than_cards(monkeypatch):
    """A torchrun world larger than the CUDA device count is an error before
    any rank joins (a card is never shared by the app)."""
    from construction_clip_tpu_torch.apps import train_clip

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="WORLD_SIZE 2 exceeds the 1 CUDA devices"):
        train_clip.main(["--device", "cuda"])


def test_app_refuses_a_world_that_does_not_divide_the_step_batch(tmp_path):
    """Where the JAX app trains on fewer chips, a torchrun world cannot drop
    ranks: one group of 3 rows over 2 ranks is an error."""
    from construction_clip_tpu_torch.apps import train_clip

    dp = types.SimpleNamespace(rank=0, world=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="step batch 3 .* divisible by the 2 ranks"):
        train_clip.train(train_clip.parse_args(_app_argv(tmp_path, groups=1)), dp)


# ---- the repairs ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


@pytest.mark.parametrize("app", ["predict_zeroshot", "parse_corpus", "predict_t5"])
def test_apps_compute_in_fp32_on_the_card(app, monkeypatch):
    """The three apps load their weights in fp32 on a CUDA device, as their
    JAX counterparts run DEFAULT_POLICY everywhere (no card needed: the
    device is a torch.device("cuda") object, and the load stops the app)."""
    import importlib

    mod = importlib.import_module(f"construction_clip_tpu_torch.apps.{app}")
    dtypes = []

    def to_params(tree, *, dtype=None, device=None, trainable=False):
        dtypes.append((dtype, device))
        raise _Stop

    monkeypatch.setattr(mod, "resolve_device", lambda name: torch.device("cuda"))
    monkeypatch.setattr(convert, "to_params", to_params)
    monkeypatch.setattr(mod, "load_clip_tokenizer", lambda *a, **k: None)
    monkeypatch.setattr(mod, "TokenizerFile", lambda path: types.SimpleNamespace(
        vocab_size=lambda: 100), raising=False)
    argv = {"predict_zeroshot": ["--arch", "tiny"], "parse_corpus": ["--arch", "tiny"],
            "predict_t5": ["--arch", "tiny", "--t5_size", "tiny"]}[app]
    with pytest.raises(_Stop):
        mod.main(argv)
    assert dtypes == [(torch.float32, torch.device("cuda"))]


def test_load_params_npz_checks_shapes_against_the_config(tmp_path):
    """A checkpoint of another config fails at load time, naming the key:
    tiny's 256-token embedding against tiny_bpe's 520."""
    path = str(tmp_path / "tiny.npz")
    checkpoint.save_params_npz(path, convert.to_params(convert.init_clip(0, CLIPConfig.tiny())))
    with pytest.raises(ValueError, match="'text/tok_emb' has shape \\(256, 32\\)"):
        checkpoint.load_params_npz(path, convert.init_clip(convert.SHAPES, CLIPConfig.tiny_bpe()))
    from construction_clip_tpu_torch.apps.common import load_clip

    with pytest.raises(ValueError, match="text/tok_emb"):
        load_clip(path, arch="tiny_bpe")
    tree, _ = load_clip(path, arch="tiny")
    _tree_close(tree, convert.init_clip(0, CLIPConfig.tiny()), rtol=0, atol=0)


def test_load_params_npz_names_a_missing_key(tmp_path):
    path = str(tmp_path / "cut.npz")
    with np.load(_saved(tmp_path)) as data:
        np.savez(path, **{k: data[k] for k in data.files if k != "vision/ln_post/scale"})
    with pytest.raises(KeyError, match="vision/ln_post/scale"):
        checkpoint.load_params_npz(path, convert.init_clip(convert.SHAPES, CLIPConfig.tiny()))


def _saved(tmp_path):
    path = str(tmp_path / "full.npz")
    checkpoint.save_params_npz(path, convert.to_params(convert.init_clip(0, CLIPConfig.tiny())))
    return path


def test_shapes_template_matches_the_init():
    """convert.SHAPES gives every init_* tree's keys, shapes and dtypes
    without drawing (zero-stride views)."""
    from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config, T5Config

    for init, args in ((convert.init_clip, (CLIPConfig.tiny(),)),
                       (convert.init_clipcap, (ClipCapConfig(clip_dim=32), GPT2Config.tiny())),
                       (convert.init_clipcap_t5, (ClipCapConfig(clip_dim=32), T5Config.tiny()))):
        full, shapes = init(0, *args), init(convert.SHAPES, *args)
        got = tree_map(lambda a: (a.shape, a.dtype), shapes)
        assert got == tree_map(lambda a: (a.shape, a.dtype), full)
    big = convert.init_clip(convert.SHAPES, CLIPConfig.vit_l_14())
    assert not any(big["vision"]["blocks"]["mlp"]["w_fc"].strides)
