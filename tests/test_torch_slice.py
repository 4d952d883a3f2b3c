"""PyTorch port, the serving slice end to end against the JAX package: the
port's CaptionPipeline on the same params and images gives the same attributes
and captions; TorchPredictService answers over HTTP through the port's
make_handler (serve/http.py, its copy of the JAX package's); and the port runs
without importing jax or anything of the JAX package."""

import gzip
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import jax
import torch

from construction_clip_tpu.data.clip_tokenizer import ClipTokenizer
from construction_clip_tpu.data.preprocess import preprocess_batch as j_preprocess
from construction_clip_tpu.infer.caption import CaptionPipeline as JaxPipeline
from construction_clip_tpu.models.clip import init_clip
from construction_clip_tpu.models.clipcap import init_clipcap
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, ClipCapConfig, GPT2Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.infer import caption as cap_mod
from construction_clip_tpu_torch.infer.caption import CaptionPipeline
from construction_clip_tpu_torch.infer.decode import DecodeResult
from construction_clip_tpu_torch.serve.app import TorchPredictService, make_handler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_CFG = CLIPConfig(
    vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=1, heads=2,
                        embed_dim=16),
    text=TextConfig(vocab_size=600, context_length=12, width=32, layers=1, heads=2,
                    embed_dim=16))
GCFG = GPT2Config(vocab_size=120, n_positions=64, n_embd=32, n_layer=1, n_head=2)
CCFG = ClipCapConfig(prefix_length=2, attribute_length=4, clip_dim=16)
VIOLATION_TYPES = ("墜落", "機械", "物料", "感電", "防護具", "穿刺", "爆炸", "工作場所", "搬運")


class TinyLMTok:
    def encode(self, text):
        return [ord(c) % 90 + 3 for c in text][:8]

    def decode(self, ids, skip_special_tokens=True):
        if skip_special_tokens:  # id 0 is [PAD], like the BERT-zh vocab
            ids = [i for i in ids if int(i) != 0]
        return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    merges = tmp_path_factory.mktemp("tok") / "m.txt.gz"
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("version\n")
    clip_params = init_clip(jax.random.key(0), CLIP_CFG)
    cap_params = init_clipcap(jax.random.key(1), CCFG, GCFG)
    common = dict(clip_cfg=CLIP_CFG, ccfg=CCFG, gcfg=GCFG,
                  clip_tokenizer=ClipTokenizer(str(merges), n_merges=None),
                  lm_tokenizer=TinyLMTok(), stop_token=119, max_steps=5, beam_size=2)
    jpipe = JaxPipeline(clip_params=clip_params, cap_params=cap_params, **common)
    tpipe = CaptionPipeline(clip_params=convert.to_params(clip_params),
                            cap_params=convert.to_params(cap_params), **common)
    return jpipe, tpipe


def _images(rng, n):
    return (rng.random((n, 48, 48, 3)) * 255).astype(np.uint8)


@pytest.mark.parametrize("use_beam", [True, False])
def test_caption_images_match_jax(pipes, use_beam, rng):
    jpipe, tpipe = pipes
    u8 = _images(rng, 3)
    want = jpipe.caption_images(j_preprocess(u8, 32), use_beam=use_beam)
    got = tpipe.caption_images(preprocess_batch(u8, 32), use_beam=use_beam)
    assert got == want


def test_explicit_attributes_match_jax(pipes, rng):
    jpipe, tpipe = pipes
    u8, attrs = _images(rng, 2), ["缺失 墜落 ", "現況 機械 "]
    want = jpipe.caption_images(j_preprocess(u8, 32), attributes=attrs)
    got = tpipe.caption_images(preprocess_batch(u8, 32), attributes=attrs)
    assert got == want
    assert got[0]["caption_type"] == "violation" and got[1]["caption_type"] == "status"
    jemb, jattrs = jpipe.classify_and_embed(j_preprocess(u8, 32))
    temb, tattrs = tpipe.classify_and_embed(preprocess_batch(u8, 32))
    assert tattrs == jattrs
    # fp32 one-layer towers: sums in another order than XLA's
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-5)


def test_collapse_guard_falls_back_to_greedy(pipes, rng, monkeypatch):
    _, tpipe = pipes
    imgs = preprocess_batch(_images(rng, 2), 32)
    attrs = ["缺失 墜落 ", "現況 機械 "]
    expected = tpipe.caption_images(imgs, attributes=attrs, use_beam=False)

    def collapsed_beam(params, gcfg, embeds, **kw):
        b = embeds.shape[0]
        return DecodeResult(
            tokens=torch.zeros((b, tpipe.beam_size, tpipe.max_steps), dtype=torch.int32),
            lengths=torch.full((b, tpipe.beam_size), tpipe.max_steps, dtype=torch.int32),
            scores=torch.zeros((b, tpipe.beam_size)))

    monkeypatch.setattr(cap_mod, "beam_decode", collapsed_beam)
    out = tpipe.caption_images(imgs, attributes=attrs, use_beam=True)
    assert [o["caption"] for o in out] == [e["caption"] for e in expected]
    assert all(o["decode_suspect"] is False for o in out)


def _multipart(filename, data):
    boundary = "XxBoUnDaRyxX"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"{filename}\"\r\nContent-Type: application/octet-stream"
            f"\r\n\r\n").encode() + data + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def test_http_round_trip(pipes, rng):
    from PIL import Image

    _, tpipe = pipes
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(TorchPredictService(tpipe)))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(_images(rng, 1)[0]).save(buf, format="PNG")
        body, ctype = _multipart("site.png", buf.getvalue())
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_port}/predict",
                                     data=body, headers={"Content-Type": ctype},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            status, out = r.status, json.loads(r.read().decode())
    finally:
        httpd.shutdown()
        server.join(timeout=10)
    assert status == 200
    assert set(out) == {"boxes", "labels", "scores", "caption_type", "violation_type",
                        "caption"}
    assert out["caption_type"] in ("violation", "status")
    assert out["violation_type"] in VIOLATION_TYPES
    assert isinstance(out["caption"], str)


def test_batched_requests_coalesce(pipes, rng):
    import concurrent.futures as cf

    _, tpipe = pipes
    svc = TorchPredictService(tpipe, use_beam=True, batch_window_ms=100, max_batch=4)
    sizes = []
    orig = svc._caption_batch

    def counted(staged):
        sizes.append(len(staged))
        return orig(staged)

    svc._caption_batch = counted
    imgs = [(rng.random((40 + 8 * i, 56, 3)) * 255).astype(np.uint8) for i in range(4)]
    with cf.ThreadPoolExecutor(4) as pool:
        results = list(pool.map(svc.predict, imgs))
    assert len(results) == 4 and max(sizes) > 1
    for r in results:
        assert r["caption_type"] in ("violation", "status")
        assert r["violation_type"] in VIOLATION_TYPES


NO_JAX_SCRIPT = r"""
import gzip, os, sys, tempfile
import numpy as np
from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, ClipCapConfig, GPT2Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.infer.caption import CaptionPipeline
from construction_clip_tpu_torch.serve.app import TorchPredictService

clip_cfg = CLIPConfig(
    vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=1, heads=2, embed_dim=16),
    text=TextConfig(vocab_size=600, context_length=12, width=32, layers=1, heads=2,
                    embed_dim=16))
gcfg = GPT2Config(vocab_size=120, n_positions=64, n_embd=32, n_layer=1, n_head=2)
ccfg = ClipCapConfig(prefix_length=2, attribute_length=4, clip_dim=16)

class Tok:
    def encode(self, text):
        return [ord(c) % 90 + 3 for c in text][:8]
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(str(i) for i in ids)

with tempfile.TemporaryDirectory() as d:
    merges = os.path.join(d, "m.txt.gz")
    with gzip.open(merges, "wt", encoding="utf-8") as f:
        f.write("version\n")
    pipe = CaptionPipeline(
        clip_params=convert.to_params(convert.init_clip(0, clip_cfg)), clip_cfg=clip_cfg,
        cap_params=convert.to_params(convert.init_clipcap(1, ccfg, gcfg)), ccfg=ccfg,
        gcfg=gcfg, clip_tokenizer=ClipTokenizer(merges, n_merges=None), lm_tokenizer=Tok(),
        stop_token=119, max_steps=4, beam_size=2)
    out = TorchPredictService(pipe).predict(
        (np.random.default_rng(0).random((40, 50, 3)) * 255).astype(np.uint8))
assert out["caption_type"] in ("violation", "status"), out

# the training slice: the CLI's modules, the loader, one step, the checkpoints
import torch
from construction_clip_tpu_torch.apps import train_clip
from construction_clip_tpu_torch.data.loader import TorchImageTextLoader
from construction_clip_tpu_torch.train import checkpoint, contrastive, resilience, state

class Pairs:
    def __len__(self):
        return 2
    def __getitem__(self, i):
        return ["a.jpg", "b.jpg"], ["x", "y"]

loader = TorchImageTextLoader(
    Pairs(), lambda texts: np.ones((len(texts), 12), np.int32), batch_size=1,
    image_size=40, load_image=lambda f: np.zeros((40, 48, 3), np.uint8))
batch = next(iter(loader))
assert batch["images"].shape == (2, 40, 40, 3) and batch["tokens"].dtype == torch.int32
tx = state.make_adamw(1e-4, warmup_steps=0)
st = state.TrainState.create(
    convert.to_params(convert.init_clip(0, clip_cfg), trainable=True), tx)
rng = np.random.default_rng(1)
st, m = contrastive.make_train_step(clip_cfg, tx)(
    st, {"images": torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
         "tokens": torch.from_numpy(rng.integers(1, 600, (2, 12)).astype(np.int32))})
assert bool(torch.isfinite(m["loss"]))
with tempfile.TemporaryDirectory() as d:
    checkpoint.save_state(d, st)
    checkpoint.save_params_npz(os.path.join(d, "p.npz"), st.params)
with resilience.StepWatchdog(timeout=60.0) as watchdog:
    watchdog.tick()

# the data-parallel slice: its modules, and two spawned ranks taking their rows
from construction_clip_tpu_torch.core import mesh
from construction_clip_tpu_torch.ops import collectives
from construction_clip_tpu_torch.parallel import infonce

rows = mesh.spawn_ranks(mesh.shard_batch, 2, ({"x": np.arange(4)},), device="cpu",
                       timeout=60)
assert [r["x"].tolist() for r in rows] == [[0, 1], [2, 3]], rows

# the mT5 slice: the app's batch function on the tiny CLIP above and a tiny T5
from construction_clip_tpu_torch.apps import predict_t5
from construction_clip_tpu_torch.core.configs import T5Config
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY
from construction_clip_tpu_torch.data.schema import Annotation
from construction_clip_tpu_torch.models.t5 import quantize_t5_head

tcfg = T5Config.tiny()
t5_ccfg = ClipCapConfig(prefix_length=2, attribute_length=0, clip_dim=16)
cap = convert.to_params(convert.init_clipcap_t5(2, t5_ccfg, tcfg)).tree()
cap = dict(cap, t5=quantize_t5_head(cap["t5"]))
process = predict_t5.make_process(
    pipe.clip_params, clip_cfg, cap, t5_ccfg, tcfg, pipe.clip_tokenizer, Tok(), max_length=4,
    policy=DEFAULT_POLICY, device="cpu")
records, res = process([Annotation(id=0, file_name="a.jpg")],
                       (np.random.default_rng(1).random((1, 40, 40, 3)) * 255).astype(np.uint8))
assert len(records) == 1 and tuple(res.tokens.shape) == (1, 4), records

# int8 serving: the port's serve app builds the quantized service (K7's wrapper
# in the image tower, int8 GPT-2) and answers a request
from construction_clip_tpu_torch.apps import serve

class ClipTok:
    def tokenize(self, texts, context_length):
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [254] + [ord(c) % 200 + 1 for c in text][: context_length - 2] + [255]
            out[row, :len(ids)] = ids
        return out

args = serve.parse_args(["--arch", "tiny", "--prefix_length", "2", "--attribute_length", "4",
                         "--int8", "--device", "cpu"])
svc = serve.build_service(args, ClipTok(), Tok(), torch.device("cpu"))
svc.pipe.max_steps = 3
out = svc.predict((np.random.default_rng(2).random((40, 50, 3)) * 255).astype(np.uint8))
assert out["caption_type"] in ("violation", "status"), out

# zero-shot and the prefix-corpus precompute with the fused MLP on (K9's and
# K6's wrappers), and the two apps' modules
from construction_clip_tpu_torch.apps import parse_corpus, predict_zeroshot
from construction_clip_tpu_torch.data.preprocess import preprocess_staged
from construction_clip_tpu_torch.infer import precompute, zeroshot
from construction_clip_tpu_torch.models import blocks

blocks.USE_FUSED_MLP = True
feats = zeroshot.label_features(pipe.clip_params, clip_cfg,
                                ClipTok().tokenize(["a", "b", "c"], 12))
staged = (np.random.default_rng(3).random((2, 32, 32, 3)) * 255).astype(np.uint8)
probs, pred = zeroshot.classify_batch(pipe.clip_params, clip_cfg, preprocess_staged(staged),
                                      feats)
assert tuple(probs.shape) == (2, 3), probs.shape
archive = precompute.precompute_corpus(
    pipe.clip_params, clip_cfg, [Annotation(id=0, file_name="a.jpg")], ClipTok(),
    load_image=lambda path: np.zeros((40, 48, 3), np.uint8))
assert archive["embeddings"].shape == (1, 16), archive["embeddings"].shape

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "construction_clip_tpu",
                                    "make_offline_assets"))
print("JAX_MODULES", bad)
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
