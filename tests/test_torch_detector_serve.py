"""PyTorch port, detection serving against the JAX package on the CPU:
TorchDetector.detect_batch against JaxDetector.detect_batch on both staging
geometries, TorchPredictService with a detector against the JAX package's
PredictService (coalesced batches from several threads), the serve app's
--enable_detector, and the port's eval_detection app against
apps/eval_detection.py run in-process. Both packages load one
torchvision-layout .pth (test_detection._synthetic_tv_state_dict), whose
folded BatchNorm keeps the detector well conditioned, so every detection
compares one to one. Every port object runs with device="cpu".
"""

import contextlib
import gzip
import io
import json
import os
import runpy
import sys
import concurrent.futures as cf

import numpy as np
import pytest

import jax
import torch

from construction_clip_tpu.data.clip_tokenizer import ClipTokenizer
from construction_clip_tpu.infer.caption import CaptionPipeline as JaxPipeline
from construction_clip_tpu.models.clip import init_clip
from construction_clip_tpu.models.clipcap import init_clipcap
from construction_clip_tpu.serve.app import PredictService as JaxPredictService
from construction_clip_tpu.serve.detector import JaxDetector
from construction_clip_tpu.serve.detector import ThresholdWrapper as JaxThresholdWrapper
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import (
    CLIPConfig, ClipCapConfig, GPT2Config, TextConfig, VisionConfig)
from construction_clip_tpu_torch.data.labels import DETECTOR_CLASSES
from construction_clip_tpu_torch.infer.caption import CaptionPipeline
from construction_clip_tpu_torch.serve.app import TorchPredictService
from construction_clip_tpu_torch.serve.detector import ThresholdWrapper, TorchDetector

from test_detection import _synthetic_tv_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 128   # the detectors' staging square
# mapped-back detections: the same count and labels, boxes within 1e-2 px of
# the original image (1e-3 px on the staged square times a scale up to 2.4) +
# 1e-4 relative, scores within 1e-4
BOX_TOL = dict(rtol=1e-4, atol=1e-2)
SCORE_ATOL = 1e-4
ASPECTS = [(96, 160), (200, 120), (128, 128), (75, 300)]   # (h, w)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("det") / "model_final.pth"
    torch.save(_synthetic_tv_state_dict(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def detectors(checkpoint):
    """JaxDetector and TorchDetector on one .pth: 8 classes (the state dict's
    head), SIZE-px letterbox, fp32."""
    jd = JaxDetector(checkpoint, num_classes=8, image_size=SIZE)
    td = TorchDetector(checkpoint, num_classes=8, image_size=SIZE, device="cpu")
    assert td.compute_dtype == torch.float32 and td.device.type == "cpu"
    return jd, td


def _images(seed, shapes):
    gen = np.random.default_rng(seed)
    return [(gen.random(hw + (3,)) * 255).astype(np.uint8) for hw in shapes]


def _assert_same_detections(got: dict, want: dict, what: str):
    assert len(got["scores"]) == len(want["scores"]) > 0, what
    assert got["labels"] == want["labels"], what
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=SCORE_ATOL,
                               err_msg=what)
    np.testing.assert_allclose(np.asarray(got["boxes"]), np.asarray(want["boxes"]),
                               err_msg=what, **BOX_TOL)


@pytest.mark.parametrize("geometry", ["letterbox", "crop"])
def test_detect_batch_matches_jax(detectors, geometry):
    """Staging, one batched forward and the map back to each image's pixels,
    on images of several aspects: the same staged arrays and, image by
    image, the same detections; every mapped-back box inside its image."""
    jd, td = detectors
    jd.geometry = td.geometry = geometry
    try:
        images = _images(1, ASPECTS)
        staged = [td.stage(im) for im in images]
        for s, im in zip(staged, images):
            np.testing.assert_array_equal(s, jd.stage(im))
        sizes = [im.shape[:2] for im in images]
        got = td.detect_batch(np.stack(staged), sizes)
        want = jd.detect_batch(np.stack(staged), sizes)
    finally:
        jd.geometry = td.geometry = "letterbox"
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_detections(g, w, f"{geometry} image {i} {sizes[i]}")
        h, wd = sizes[i]
        b = np.asarray(g["boxes"])
        assert (b >= 0).all() and (b[:, [0, 2]] <= wd).all() and (b[:, [1, 3]] <= h).all()


CLIP_CFG = CLIPConfig(
    vision=VisionConfig(image_size=32, patch_size=8, width=32, layers=1, heads=2,
                        embed_dim=16),
    text=TextConfig(vocab_size=600, context_length=12, width=32, layers=1, heads=2,
                    embed_dim=16))
GCFG = GPT2Config(vocab_size=120, n_positions=64, n_embd=32, n_layer=1, n_head=2)
CCFG = ClipCapConfig(prefix_length=2, attribute_length=4, clip_dim=16)


class TinyLMTok:
    def encode(self, text):
        return [ord(c) % 90 + 3 for c in text][:8]

    def decode(self, ids, skip_special_tokens=True):
        if skip_special_tokens:
            ids = [i for i in ids if int(i) != 0]
        return " ".join(str(int(i)) for i in ids)


class TinyClipTok:
    """Label prompts as ids below CLIPConfig.tiny's 256-token text vocab, the
    end-of-text id (255) the largest."""

    def tokenize(self, texts, context_length):
        out = np.zeros((len(texts), context_length), np.int32)
        for row, text in enumerate(texts):
            ids = [254] + [ord(c) % 200 + 1 for c in text][: context_length - 2] + [255]
            out[row, :len(ids)] = ids
        return out


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
    return (JaxPipeline(clip_params=clip_params, cap_params=cap_params, **common),
            CaptionPipeline(clip_params=convert.to_params(clip_params),
                            cap_params=convert.to_params(cap_params), **common))


@pytest.mark.parametrize("threshold", [0.0, 0.8])
def test_service_with_a_detector_answers_as_jax(pipes, detectors, threshold):
    """TorchPredictService and the JAX package's PredictService, each with
    its detector behind ThresholdWrapper, a 500 ms window and max_batch 4,
    answer 4 requests from 4 threads: the detector's batch coalesces in
    both, and each request's JSON is the same (labels and the caption's
    fields exact, boxes and scores within the tolerances). At threshold 0
    the label names come from DETECTOR_CLASSES; at the reference's 0.8 the
    weights here score no detection."""
    jpipe, tpipe = pipes
    jd, td = detectors
    images = _images(2, ASPECTS)
    answers, batches = {}, {}
    for name, cls, pipe, det, wrap in (
            ("jax", JaxPredictService, jpipe, jd, JaxThresholdWrapper),
            ("port", TorchPredictService, tpipe, td, ThresholdWrapper)):
        svc = cls(pipe, detector=wrap(det, threshold=threshold), batch_window_ms=500,
                  max_batch=4)
        sizes = batches[name] = []
        inner = svc._detect_batch

        def counted(staged, sz, inner=inner, sizes=sizes):
            sizes.append(len(staged))
            return inner(staged, sz)

        svc._detect_batch = counted
        with cf.ThreadPoolExecutor(4) as pool:
            answers[name] = list(pool.map(svc.predict, images))
    assert max(batches["port"]) >= 2 and max(batches["jax"]) >= 2, batches
    for i, (got, want) in enumerate(zip(answers["port"], answers["jax"])):
        assert set(got) == {"boxes", "labels", "scores", "caption_type", "violation_type",
                            "caption"}
        for key in ("caption_type", "violation_type", "caption", "labels"):
            assert got[key] == want[key], (i, key)
        if threshold > 0:
            assert got["boxes"] == got["labels"] == got["scores"] == []
        else:
            _assert_same_detections(got, want, f"request {i}")
            assert set(got["labels"]) <= set(DETECTOR_CLASSES[1:])
        json.dumps(got, ensure_ascii=False)


def test_serve_app_builds_the_detector_on_its_device():
    """--enable_detector builds ThresholdWrapper(TorchDetector) on --device,
    with the detector flags, and a request answers with detections."""
    from construction_clip_tpu_torch.apps import serve as serve_app

    args = serve_app.parse_args(["--arch", "tiny", "--prefix_length", "2",
                                 "--attribute_length", "4", "--enable_detector",
                                 "--detector_image_size", "64", "--detector_geometry", "crop",
                                 "--detector_num_classes", "5", "--device", "cpu"])
    svc = serve_app.build_service(args, TinyClipTok(), TinyLMTok(), torch.device("cpu"))
    det = svc.detector
    assert isinstance(det, ThresholdWrapper) and isinstance(det.inner, TorchDetector)
    assert (det.inner.image_size, det.inner.geometry, det.inner.num_classes) == (64, "crop", 5)
    assert det.threshold == 0.8 and det.inner.device.type == "cpu"
    assert det.inner.params["box_head"]["cls_score"]["w"].shape == (1024, 5)
    svc.pipe.max_steps = 3
    det.threshold = 0.0
    out = svc.predict(_images(3, [(40, 50)])[0])
    assert set(out) == {"boxes", "labels", "scores", "caption_type", "violation_type",
                        "caption"}
    assert len(out["boxes"]) == len(out["labels"]) == len(out["scores"]) > 0
    assert set(out["labels"]) <= set(DETECTOR_CLASSES[1:5])


def test_detector_refuses_a_missing_cuda_device(monkeypatch):
    """TorchDetector and the eval_detection app run on cuda by default and
    raise, naming --device cpu, where no CUDA device works."""
    from construction_clip_tpu_torch.apps import eval_detection

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        TorchDetector(image_size=64)
    assert eval_detection.parse_args(["--json_path", "x.json"]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_detection.main(["--json_path", "x.json"])


def _jax_eval_app(monkeypatch, argv):
    """apps/eval_detection.py run as its __main__ in this process: its stdout."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "apps"))
    monkeypatch.setattr(sys, "argv", ["eval_detection.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "apps", "eval_detection.py"), run_name="__main__")
    return out.getvalue()


def test_eval_detection_prints_the_jax_apps_metrics(detectors, checkpoint, tmp_path,
                                                    monkeypatch, capsys):
    """The port's eval_detection against apps/eval_detection.py on a tiny
    corpus of PNGs (one file missing): the same metrics JSON. The ground
    truth holds the port's own top detections of each image (so AP is not
    trivially 0), a box of another class, and, on the wide image, an object
    in a long side's band that clipping to the centre square excludes."""
    from PIL import Image

    _, td = detectors
    images = _images(4, [(96, 160), (128, 128), (150, 100)])
    anns = []
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / f"{i}.png")
        raw = td.detect(img)
        boxes = [list(map(float, b)) for b in raw["boxes"][:3]] + [[5.0, 5.0, 40.0, 40.0]]
        labels = [int(l) for l in raw["labels"][:3]] + [3]
        if i == 0:
            boxes.append([1.0, 10.0, 20.0, 90.0])    # in the left band of a 160-wide image
            labels.append(2)
        anns.append({"file_name": f"{i}.png", "boxes": boxes, "labels": labels})
    anns.append({"file_name": "missing.png", "boxes": [], "labels": []})
    corpus = tmp_path / "boxes.json"
    corpus.write_text(json.dumps({"annotations": anns}), encoding="utf-8")
    argv = ["--json_path", str(corpus), "--image_root", str(tmp_path), "--checkpoint",
            checkpoint, "--image_size", str(SIZE)]

    from construction_clip_tpu_torch.apps import eval_detection

    eval_detection.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    port_out = capsys.readouterr().out
    jax_out = _jax_eval_app(monkeypatch, argv)
    port = json.loads(port_out[port_out.index("{"):])
    want = json.loads(jax_out[jax_out.index("{"):])
    assert port == want
    assert json.loads((tmp_path / "port.json").read_text()) == want
    assert port["skipped_images"] == 1 and port["evaluated_images"] == 3
    assert port["gt_boxes_outside_crop"] >= 1 and port["AP50"] > 0
    assert "skip missing.png" in port_out and "skip missing.png" in jax_out
