"""PyTorch port, its own copies of the JAX package's host-only modules held
equal to the originals (CPU), the rule that the port imports nothing of the
JAX package, and the apps' --device flag."""

import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

from construction_clip_tpu.data import clip_tokenizer as j_clip_tokenizer
from construction_clip_tpu.data import datasets as j_datasets
from construction_clip_tpu.data import labels as j_labels
from construction_clip_tpu.data import pipeline as j_pipeline
from construction_clip_tpu.data import schema as j_schema
from construction_clip_tpu_torch.data import clip_tokenizer, datasets, labels, offline_assets
from construction_clip_tpu_torch.data import pipeline, schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import make_offline_assets  # noqa: E402


@pytest.mark.parametrize("name", ["CAPTION_TYPE_PROMPTS", "CAPTION_TYPES", "VIOLATION_TYPES",
                                  "VIOLATION_TYPES_EN", "DETECTOR_CLASSES"])
def test_label_constants_are_the_originals(name):
    assert getattr(labels, name) == getattr(j_labels, name)
    assert labels.attribute_string("缺失", "墜落") == j_labels.attribute_string("缺失", "墜落")


def test_offline_writers_write_the_same_bytes(tmp_path, monkeypatch):
    """Both writers' merges and vocab files, byte for byte (gzip stamps the
    time into its header, so both write at one fixed time)."""
    monkeypatch.setattr("time.time", lambda: 1700000000.0)
    corpus = tmp_path / "all.json"
    corpus.write_text(json.dumps({"annotations": [
        {"caption": "工地 邊緣 墜落", "violation_list": "開口", "objects": "ab"}]},
        ensure_ascii=False), encoding="utf-8")
    assert offline_assets.corpus_characters([str(corpus)]) == \
        make_offline_assets.corpus_characters([str(corpus)])
    chars = offline_assets.corpus_characters([])
    for sub, mod in (("port", offline_assets), ("jax", make_offline_assets)):
        (tmp_path / sub).mkdir()
        mod.write_clip_merges(str(tmp_path / sub / "merges.txt.gz"))
        mod.write_bert_vocab(str(tmp_path / sub / "vocab.txt"), chars)
        mod.write_bert_vocab(str(tmp_path / sub / "tiny.txt"), chars, size=128)
    for name in ("merges.txt.gz", "vocab.txt", "tiny.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_clip_tokenizer_gives_the_original_ids(tmp_path):
    merges = str(tmp_path / "merges.txt.gz")
    offline_assets.write_clip_merges(merges)
    port, jax_tok = clip_tokenizer.ClipTokenizer(merges), j_clip_tokenizer.ClipTokenizer(merges)
    assert port.vocab_size == jax_tok.vocab_size == 49408
    texts = list(labels.CAPTION_TYPE_PROMPTS) + list(labels.VIOLATION_TYPES) + [
        "a worker's helmet at 3 m", "Don't &amp; can't"]
    np.testing.assert_array_equal(port.tokenize(texts, 77), jax_tok.tokenize(texts, 77))
    ids = port.encode(texts[-2])
    assert port.decode(ids) == jax_tok.decode(ids)


def _corpus(tmp_path):
    anns = [{"id": i, "caption_type": "violation", "violation_type": vt,
             "violation_list": f"v{i}", "caption": f"c{i}" if i % 2 else "",
             "file_name": f"im{i}.jpg", "objects": "", "page": i}
            for i, vt in enumerate(["墜落", "機械", "物料"] * 4)]
    path = tmp_path / "all.json"
    path.write_text(json.dumps({"type": "captions", "annotations": anns}, ensure_ascii=False),
                    encoding="utf-8")
    return str(path)


def test_load_annotations_gives_the_original_records(tmp_path):
    path = _corpus(tmp_path)
    got = [a.to_dict() for a in schema.load_annotations(path)]
    assert got == [a.to_dict() for a in j_schema.load_annotations(path)]
    out = tmp_path / "saved.json"
    schema.save_annotations(str(out), schema.load_annotations(path))
    assert [a.to_dict() for a in j_schema.load_annotations(str(out))] == got


@pytest.mark.parametrize("split", ["train", "test"])
def test_pair_group_dataset_gives_the_original_items(tmp_path, split):
    path = _corpus(tmp_path)
    kw = dict(key="violation_type", split=split, combination_num=2)
    port, orig = datasets.PairGroupDataset(path, **kw), j_datasets.PairGroupDataset(path, **kw)
    assert len(port) == len(orig) > 0
    assert [port[i] for i in range(len(port))] == [orig[i] for i in range(len(orig))]


@pytest.mark.parametrize("hw", [(256, 256), (480, 640), (301, 257), (1080, 1920), (40, 50)])
def test_host_shape_unify_gives_the_original_arrays(hw):
    img = (np.random.default_rng(hw[0]).random(hw + (3,)) * 255).astype(np.uint8)
    got = pipeline.host_shape_unify(img, 256)
    assert got.shape == (256, 256, 3)
    np.testing.assert_array_equal(got, j_pipeline.host_shape_unify(img, 256))


def test_stream_corpus_gives_the_original_batches(tmp_path):
    """The apps' corpus stream (the port's apps/common.py copy of the JAX
    apps' one): the same annotations and staged arrays, unreadable files
    skipped, over PIL-written JPEGs of several sizes."""
    import importlib.util

    from PIL import Image

    from construction_clip_tpu_torch.apps.common import stream_corpus

    spec = importlib.util.spec_from_file_location("jax_apps_common",
                                                  os.path.join(REPO, "apps", "common.py"))
    j_common = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_common)
    gen = np.random.default_rng(9)
    for i, hw in enumerate([(40, 50), (256, 256), (300, 120), (64, 64), (90, 33)]):
        Image.fromarray((gen.random(hw + (3,)) * 255).astype(np.uint8)).save(tmp_path / f"{i}.jpg")
    anns = [schema.Annotation(id=i, file_name=f"{i}.jpg") for i in range(5)]
    anns.insert(2, schema.Annotation(id=9, file_name="missing.jpg"))
    for size, batch in ((256, 2), (64, 10)):
        got = list(stream_corpus(anns, str(tmp_path), batch, stage_size=size))
        want = list(j_common.stream_corpus(anns, str(tmp_path), batch, stage_size=size))
        assert [[a.id for a in b] for b, _ in got] == [[a.id for a in b] for b, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g.shape[1:] == (size, size, 3)
            np.testing.assert_array_equal(g, w)


def _python_files():
    root = os.path.join(REPO, "construction_clip_tpu_torch")
    for dirpath, _, files in os.walk(root):
        yield from (os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py"))
    yield from (os.path.join(REPO, f) for f in ("chip_smoke.py", "chip_ab.py"))


def _imports(path):
    """Every module an import statement names, at any depth of the file."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    """An AST scan, so imports inside functions count too: no jax, no
    construction_clip_tpu(.*), no tools/make_offline_assets."""
    bad = []
    for path in _python_files():
        for module in _imports(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "construction_clip_tpu", "make_offline_assets"):
                bad.append(f"{os.path.relpath(path, REPO)}: {module}")
    assert bad == []


@pytest.mark.parametrize("app", ["train_clip", "predict_t5", "serve", "predict_zeroshot",
                                 "parse_corpus"])
def test_apps_refuse_a_missing_cuda_device(app, monkeypatch):
    """--device defaults to cuda; without a usable CUDA device the app stops
    at once and names --device cpu, instead of running on the CPU."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"construction_clip_tpu_torch.apps.{app}")
    assert mod.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        mod.main([])


def test_tokenizer_file_reads_the_offline_bert_vocab(tmp_path):
    """The apps' --tokenizer reader on a BERT vocab.txt: [CLS] ids [SEP], with
    the canonical special ids the beam's stop token relies on."""
    from construction_clip_tpu_torch.apps.common import TokenizerFile

    path = str(tmp_path / "vocab.txt")
    offline_assets.write_bert_vocab(path, offline_assets.corpus_characters([]))
    tok = TokenizerFile(path)
    ids = tok.encode(labels.attribute_string("缺失", "墜落"))
    assert ids[0] == 101 and ids[-1] == 102 and len(ids) == 6 and tok.vocab_size() == 21128
    assert tok.decode(ids).replace(" ", "") == "缺失墜落"
