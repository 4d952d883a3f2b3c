"""PyTorch port, zero-shot classification (infer/zeroshot.py) and the corpus
precompute (infer/precompute.py:precompute_corpus) against the JAX package on
the same params and inputs (CPU, fp32), with the fused MLP off (the default)
and on, and the apps predict_zeroshot and parse_corpus end to end in a
subprocess on a small PIL-written corpus."""

import functools
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.core.configs import CLIPConfig as JCLIPConfig
from construction_clip_tpu.data.clip_tokenizer import ClipTokenizer as JClipTokenizer
from construction_clip_tpu.data.preprocess import preprocess_batch as j_preprocess_batch
from construction_clip_tpu.data.schema import Annotation as JAnnotation
from construction_clip_tpu.infer import precompute as jprecompute
from construction_clip_tpu.infer import zeroshot as jzeroshot
from construction_clip_tpu.models import blocks as jblocks
from construction_clip_tpu.models import clip as jclip
from construction_clip_tpu.ops import attention as jattention
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.data import offline_assets
from construction_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer
from construction_clip_tpu_torch.data.labels import CAPTION_TYPE_PROMPTS, VIOLATION_TYPES
from construction_clip_tpu_torch.data.schema import Annotation
from construction_clip_tpu_torch.infer import precompute, zeroshot
from construction_clip_tpu_torch.models import blocks
from construction_clip_tpu_torch.ops import mlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 towers: GEMM, LN and softmax sums in another order than XLA's
TOL = dict(rtol=1e-5, atol=1e-5)
CFG, JCFG = CLIPConfig.tiny_bpe(), JCLIPConfig.tiny_bpe()


@pytest.fixture(scope="module")
def params():
    jparams = jclip.init_clip(jax.random.key(5), JCFG)
    return jparams, convert.to_params(jparams).tree()


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")
    offline_assets.write_clip_merges(path, n_merges=6)   # tiny_bpe's 520-token vocab
    return path


@pytest.fixture(params=["plain_mlp", "fused_mlp"])
def mlp_mode(request, monkeypatch):
    """The default MLP, or USE_FUSED_MLP on in both packages (the JAX package
    through its Pallas kernels in interpret mode)."""
    if request.param == "fused_mlp":
        from jax.experimental import pallas as pl

        monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call,
                                                                 interpret=True))
        monkeypatch.setattr(jattention, "_IMPL", "pallas")
        monkeypatch.setattr(jblocks, "USE_FUSED_MLP", True)
        monkeypatch.setattr(blocks, "USE_FUSED_MLP", True)
    calls = []
    orig = mlp.fused_mlp_residual
    monkeypatch.setattr(mlp, "fused_mlp_residual",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    return request.param, calls


def _label_tokens(merges, which="violation"):
    texts = VIOLATION_TYPES if which == "violation" else CAPTION_TYPE_PROMPTS
    return ClipTokenizer(merges).tokenize(list(texts), CFG.text.context_length)


def test_label_features_match_jax(params, merges, mlp_mode):
    jparams, tparams = params
    toks = _label_tokens(merges)
    want = jzeroshot.label_features(jparams, JCFG, jnp.asarray(toks))
    got = zeroshot.label_features(tparams, CFG, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(mlp_mode[1]) == (CFG.text.layers if mlp_mode[0] == "fused_mlp" else 0)


@pytest.mark.parametrize("which", ["violation", "caption"])
def test_classify_batch_matches_jax(params, merges, which, mlp_mode):
    jparams, tparams = params
    toks = _label_tokens(merges, which)
    images = np.random.default_rng(21).standard_normal((5, 32, 32, 3)).astype(np.float32)
    jfeats = jzeroshot.label_features(jparams, JCFG, jnp.asarray(toks))
    want_p, want_c = jzeroshot.classify_batch(jparams, JCFG, jnp.asarray(images), jfeats)
    feats = zeroshot.label_features(tparams, CFG, toks)
    got_p, got_c = zeroshot.classify_batch(tparams, CFG, torch.from_numpy(images), feats)
    assert got_p.dtype == torch.float32 and tuple(got_p.shape) == (5, len(toks))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_classify_matches_jax(params, merges, mlp_mode):
    jparams, tparams = params
    toks = _label_tokens(merges)
    images = np.random.default_rng(22).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want_p, want_c = jzeroshot.classify(jparams, JCFG, jnp.asarray(images), jnp.asarray(toks))
    got_p, got_c = zeroshot.classify(tparams, CFG, torch.from_numpy(images), toks)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    if mlp_mode[0] == "fused_mlp":   # every block of both towers
        assert len(mlp_mode[1]) == CFG.text.layers + CFG.vision.layers


def _annotations(cls, n, missing=()):
    vts = ["墜落", "機械", "物料"]
    return [cls(id=i, caption_type="violation" if i % 2 else "status",
                violation_type=vts[i % 3], violation_list=f"缺失{i}",
                caption="" if i % 3 == 0 else f"說明{i}",
                file_name=("gone.jpg" if i in missing else f"im{i}.jpg"))
            for i in range(n)]


def _images(n):
    gen = np.random.default_rng(23)
    shapes = [(40, 48), (64, 64), (30, 70), (256, 256)]
    return {f"im{i}.jpg": (gen.random(shapes[i % 4] + (3,)) * 255).astype(np.uint8)
            for i in range(n)}


@pytest.mark.parametrize("batch_size", [3, 64])
def test_precompute_corpus_matches_jax(params, merges, batch_size, tmp_path, mlp_mode):
    """Through the load_image hook, with one file that cannot be read
    (skipped): embeddings within 1e-5, attributes and captions equal."""
    jparams, tparams = params
    images = _images(8)

    def load_image(path):
        name = os.path.basename(path)
        if name not in images:
            raise FileNotFoundError(path)
        return images[name]

    kw = dict(image_root="root", batch_size=batch_size, load_image=load_image)
    want = jprecompute.precompute_corpus(jparams, JCFG, _annotations(JAnnotation, 8, {4}),
                                         JClipTokenizer(merges), **kw)
    out = str(tmp_path / "emb.npz")
    got = precompute.precompute_corpus(tparams, CFG, _annotations(Annotation, 8, {4}),
                                       ClipTokenizer(merges), out_path=out, **kw)
    assert got["embeddings"].shape == (7, CFG.vision.embed_dim)
    np.testing.assert_allclose(got["embeddings"], want["embeddings"], **TOL)
    assert list(got["attributes"]) == list(want["attributes"])
    assert list(got["captions"]) == list(want["captions"])
    saved = precompute.load_archive(out)
    assert sorted(saved) == ["attributes", "captions", "embeddings"]
    np.testing.assert_array_equal(saved["embeddings"], got["embeddings"])
    assert list(saved["captions"]) == list(got["captions"])


def test_load_reference_pickle_matches_jax(tmp_path):
    """The reference parse_coco pickle, read by both packages into the same
    archive (embeddings stored as a torch tensor, as the reference saves)."""
    path = str(tmp_path / "ref.pkl")
    emb = torch.from_numpy(np.random.default_rng(24).standard_normal((3, 8)).astype(np.float32))
    anns = [{"caption": "c0", "attribute": "缺失 墜落 "},
            {"caption": "", "violation_list": "v1", "attribute": "現況 機械 "},
            {"clip_embedding": 2}]
    with open(path, "wb") as f:
        pickle.dump({"clip_embedding": emb, "captions": anns}, f)
    got, want = precompute.load_archive(path), jprecompute.load_archive(path)
    np.testing.assert_array_equal(got["embeddings"], want["embeddings"])
    for key in ("attributes", "captions"):
        assert list(got[key]) == list(want[key])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, params, merges):
    """A PIL-written corpus (one annotation without its file), the JAX params
    saved as the .npz both packages read."""
    from PIL import Image

    from construction_clip_tpu_torch.train.checkpoint import save_params_npz

    root = tmp_path_factory.mktemp("corpus")
    for name, img in _images(6).items():
        Image.fromarray(img).save(root / name, quality=95)
    anns = [a.to_dict() for a in _annotations(Annotation, 7, {6})]
    (root / "test.json").write_text(json.dumps({"type": "captions", "annotations": anns},
                                               ensure_ascii=False), encoding="utf-8")
    ckpt = str(root / "clip.npz")
    save_params_npz(ckpt, convert.to_params(params[0]))
    return root, ckpt


def _run_app(app, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", f"construction_clip_tpu_torch.apps.{app}", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def _jax_staged(root, anns):
    from construction_clip_tpu_torch.apps.common import stream_corpus

    batches = list(stream_corpus(anns, str(root), 64))
    assert len(batches) == 1
    return batches[0]


@pytest.mark.parametrize("app", ["predict_zeroshot", "parse_corpus"])
def test_app_end_to_end_on_cpu(app, corpus, params, merges, tmp_path):
    """The port's app on the CPU in a subprocess, against the JAX package's
    functions on the same params and the same staged images: predictions
    equal and probabilities within the 4 decimals the JSON keeps; or the
    archive's embeddings within 1e-5, with its attributes and captions
    equal."""
    root, ckpt = corpus
    jparams, _ = params
    common = ["--json_path", str(root / "test.json"), "--image_root", str(root),
              "--checkpoint", ckpt, "--arch", "tiny_bpe", "--clip_bpe", merges,
              "--batch_size", "4", "--device", "cpu"]
    anns = _annotations(JAnnotation, 7, {6})
    if app == "predict_zeroshot":
        out, plot = str(tmp_path / "pred.json"), str(tmp_path / "sim.png")
        stdout = _run_app(app, common + ["--out", out, "--plot", plot])
        assert "accuracy: " in stdout and "skip gone.jpg" in stdout
        assert os.path.getsize(plot) > 0
        records = json.loads(open(out, encoding="utf-8").read())
        _, staged = _jax_staged(root, _annotations(Annotation, 7, {6}))
        toks = JClipTokenizer(merges).tokenize(list(VIOLATION_TYPES), JCFG.text.context_length)
        feats = jzeroshot.label_features(jparams, JCFG, jnp.asarray(toks))
        probs, pred = jzeroshot.classify_batch(
            jparams, JCFG, j_preprocess_batch(staged, JCFG.vision.image_size), feats)
        assert [r["id"] for r in records] == list(range(6))
        assert [r["prediction"] for r in records] == [VIOLATION_TYPES[int(p)] for p in pred]
        np.testing.assert_allclose([r["probs"] for r in records], np.asarray(probs),
                                   rtol=0, atol=6e-5)
        assert [r["ground_truth"] for r in records] == [a.violation_type for a in anns[:6]]
    else:
        out = str(tmp_path / "emb" / "corpus.npz")
        assert "wrote" in _run_app(app, common + ["--out", out])
        got = dict(np.load(out, allow_pickle=True))
        want = jprecompute.precompute_corpus(jparams, JCFG, anns, JClipTokenizer(merges),
                                             image_root=str(root), batch_size=4)
        assert sorted(got) == ["attributes", "captions", "embeddings"]
        np.testing.assert_allclose(got["embeddings"], want["embeddings"], **TOL)
        assert list(got["attributes"]) == list(want["attributes"])
        assert list(got["captions"]) == list(want["captions"])


def test_predict_zeroshot_process_at_t257_takes_flash_attention(merges, monkeypatch):
    """The predict_zeroshot app's batch function (apps/predict_zeroshot.make_process,
    fp32, the app's default policy) at a narrow CLIP whose image tower has
    ViT-L/14's T = 257 (64-pixel images in patches of 4: 256 + 1 tokens), on
    the JAX package's params: the path of chip_smoke.py phase 51, where the
    tower is past K1's T <= 256 and every layer goes to flash attention (K4 on
    the card). Against the JAX package's classify_batch on the same staged
    images (its plain attention path, as the JAX tests run on the CPU):
    probabilities within TOL (fp32, sums in another order), the same
    predictions; the port's tower called flash_attention once a layer and
    never K1."""
    from construction_clip_tpu.core.configs import VisionConfig as JVisionConfig
    from construction_clip_tpu_torch.apps import predict_zeroshot
    from construction_clip_tpu_torch.core.configs import VisionConfig
    from construction_clip_tpu_torch.ops import attention_block as fab
    from construction_clip_tpu_torch.ops import flash_attention as fa

    vision = dict(image_size=64, patch_size=4, width=64, layers=2, heads=2, embed_dim=32)
    cfg = CLIPConfig(vision=VisionConfig(**vision), text=CFG.text)
    jcfg = JCLIPConfig(vision=JVisionConfig(**vision), text=JCFG.text)
    assert cfg.vision.grid ** 2 + 1 == 257
    jparams = jclip.init_clip(jax.random.key(7), jcfg)
    tparams = convert.to_params(jparams).tree()
    toks = _label_tokens(merges)
    feats = zeroshot.label_features(tparams, cfg, toks)
    calls = {"flash": 0, "k1": 0}
    flash, k1 = fa.flash_attention, fab.fused_attention_block

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fa, "flash_attention", count("flash", flash))
    monkeypatch.setattr(fab, "fused_attention_block", count("k1", k1))
    process = predict_zeroshot.make_process(tparams, cfg, feats, list(VIOLATION_TYPES),
                                            "violation_type", "cpu")
    staged = (np.random.default_rng(51).random((3, 80, 80, 3)) * 255).astype(np.uint8)
    anns = [Annotation(id=i, file_name=f"im{i}.jpg", violation_type=VIOLATION_TYPES[i])
            for i in range(3)]
    records, probs = process(anns, staged)
    assert calls == {"flash": cfg.vision.layers, "k1": 0}
    jfeats = jzeroshot.label_features(jparams, jcfg, jnp.asarray(toks))
    want_p, want_c = jzeroshot.classify_batch(
        jparams, jcfg, j_preprocess_batch(staged, jcfg.vision.image_size), jfeats)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), **TOL)
    assert [r["prediction"] for r in records] == [VIOLATION_TYPES[int(c)] for c in want_c]
