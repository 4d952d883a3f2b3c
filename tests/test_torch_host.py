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
from construction_clip_tpu.data import vocabulary as j_vocabulary
from construction_clip_tpu.infer import precompute as j_precompute
from construction_clip_tpu.infer import score as j_score
from construction_clip_tpu_torch.data import clip_tokenizer, datasets, labels, offline_assets
from construction_clip_tpu_torch.data import pipeline, schema, vocabulary
from construction_clip_tpu_torch.infer import precompute, score

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


def test_vocabulary_gives_the_original_ids():
    """The show-attend-tell vocabulary (data/vocabulary.py's copy): the same
    tokens, admitted words and ids, padded captions and decodes, over mixed
    CJK and Latin text at two frequency thresholds."""
    texts = ["工地 邊緣 未設置 護欄", "Worker on the EDGE", "工地 墜落", "the edge 開口",
             "worker worker 護欄", "", "墜落 墜落 the"]
    for text in texts:
        assert vocabulary.tokenize(text) == j_vocabulary.tokenize(text)
    for threshold in (1, 2):
        port, orig = vocabulary.Vocabulary(threshold), j_vocabulary.Vocabulary(threshold)
        port.build_vocabulary(texts)
        orig.build_vocabulary(texts)
        assert port.itos == orig.itos and port.stoi == orig.stoi and len(port) == len(orig)
        for text in texts + ["unseen 字"]:
            assert port.numericalize(text) == orig.numericalize(text)
            for max_len in (4, 12):
                ids = port.encode_caption(text, max_len)
                assert ids == orig.encode_caption(text, max_len)
                assert port.decode(ids) == orig.decode(ids)


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


@pytest.mark.parametrize("split", ["train", "test"])
def test_caption_pair_dataset_gives_the_original_items(tmp_path, split):
    path = _corpus(tmp_path)
    kw = dict(key="caption", split=split, train_ratio=0.6)   # half the captions empty
    port, orig = (datasets.CaptionPairDataset(path, **kw),
                  j_datasets.CaptionPairDataset(path, **kw))
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
    construction_clip_tpu(.*), no tools/make_offline_assets. The detector's
    modules are among the files scanned."""
    scanned = {os.path.relpath(p, REPO) for p in _python_files()}
    port = "construction_clip_tpu_torch"
    assert {f"{port}/models/resnet.py", f"{port}/models/detection.py",
            f"{port}/serve/detector.py", f"{port}/infer/detection_eval.py",
            f"{port}/apps/eval_detection.py", f"{port}/data/vocabulary.py",
            f"{port}/models/lstm_captioner.py", f"{port}/train/lstm.py",
            f"{port}/train/detection.py", f"{port}/apps/train_attention.py",
            f"{port}/apps/eval_attention.py", f"{port}/data/report_parse.py",
            f"{port}/data/etl.py", f"{port}/data/corpus.py", f"{port}/data/datasets.py",
            f"{port}/data/native_loader.py", f"{port}/apps/etl.py"} <= scanned
    bad = []
    for path in _python_files():
        for module in _imports(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "construction_clip_tpu", "make_offline_assets"):
                bad.append(f"{os.path.relpath(path, REPO)}: {module}")
    assert bad == []


@pytest.mark.parametrize("app", ["train_clip", "predict_t5", "serve", "predict_zeroshot",
                                 "parse_corpus", "train_clipcap", "predict",
                                 "train_clipcap_t5", "product_e2e", "train_clip_caption",
                                 "train_attention", "eval_attention"])
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


@pytest.mark.parametrize("drop_last", [True, False])
def test_array_loader_gives_the_original_batches(drop_last):
    """ArrayLoader (the ClipCap training's loader) against the JAX package's:
    the same shuffled batches over 3 epochs (np.random.default_rng(seed +
    epoch)), drop_last and __len__."""
    gen = np.random.default_rng(2)
    arrays = {"prefix": gen.standard_normal((11, 5)).astype(np.float32),
              "tokens": gen.integers(0, 50, (11, 6)).astype(np.int32)}
    kw = dict(batch_size=4, drop_last=drop_last, seed=9)
    port, orig = pipeline.ArrayLoader(arrays, **kw), j_pipeline.ArrayLoader(arrays, **kw)
    assert len(port) == len(orig) == (2 if drop_last else 3)
    for _ in range(3):
        got, want = list(port), list(orig._host_batches())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_tokenize_for_caption_training_gives_the_original_arrays(tmp_path):
    """Zero-padded captions cut at min(mean + 10 std, max), attributes padded
    or cut to attribute_length: equal to the JAX package's function through
    the same tokenizer (the offline BERT vocab)."""
    from construction_clip_tpu_torch.apps.common import TokenizerFile

    path = str(tmp_path / "vocab.txt")
    offline_assets.write_bert_vocab(path, offline_assets.corpus_characters([]))
    tok = TokenizerFile(path)
    archive = {"embeddings": np.random.default_rng(0).standard_normal((5, 8)),
               "captions": np.asarray(["工地", "", "墜落 邊緣 開口 未設置護欄", "機械", "a1"],
                                      dtype=object),
               "attributes": np.asarray(["缺失 墜落 ", "現況 機械 ", "", "缺失 物料 ",
                                         "缺失 感電 "], dtype=object)}
    for kw in (dict(attribute_length=3), dict(attribute_length=20, max_seq_len=4)):
        got = precompute.tokenize_for_caption_training(archive, tok, **kw)
        want = j_precompute.tokenize_for_caption_training(archive, tok, **kw)
        assert sorted(got) == sorted(want) == ["attribute", "prefix", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


SCORE_PAIRS = [("工地邊緣未設置護欄", "工地邊緣設置護欄"), ("墜落", "墜落"), ("開口", ""),
               ("a b c d e", "a b c d"), ("機械", "物料機械機械"), ("x", "y")]


@pytest.mark.parametrize("fn", ["char_bleu", "rouge_n", "rouge_l"])
def test_score_metrics_give_the_original_values(fn):
    for ref, hyp in SCORE_PAIRS:
        args = (ref, hyp) if fn == "char_bleu" else (list(ref), list(hyp))
        kws = [{"n": 1}, {"n": 2}] if fn == "rouge_n" else [{}]
        for kw in kws:
            assert getattr(score, fn)(*args, **kw) == getattr(j_score, fn)(*args, **kw)


def test_score_pairs_and_the_score_app_give_the_original_json(tmp_path, capsys):
    """score_pairs over the pairs, and the port's score app on an
    output_log.json (records without a reference skipped) printing the JSON
    of the JAX package's score_pairs."""
    from construction_clip_tpu_torch.apps import score as score_app

    assert score.score_pairs(SCORE_PAIRS) == j_score.score_pairs(SCORE_PAIRS)
    assert score.score_pairs([]) == j_score.score_pairs([])
    records = [{"ground_truth_caption": r, "caption": h} for r, h in SCORE_PAIRS]
    records.append({"ground_truth_caption": "", "caption": "墜落"})
    path = tmp_path / "output_log.json"
    path.write_text(json.dumps(records, ensure_ascii=False), encoding="utf-8")
    score_app.main([str(path)])
    assert json.loads(capsys.readouterr().out) == j_score.score_pairs(SCORE_PAIRS)


def test_visualize_writes_a_png_of_a_metric_log(tmp_path, capsys, monkeypatch):
    """The port's visualize app plots the columns of a MetricLogger JSONL
    (TensorBoard made unimportable, so the logger writes its JSONL only)."""
    from construction_clip_tpu_torch.apps import visualize
    from construction_clip_tpu_torch.train.metrics import MetricLogger

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(sys.modules, mod, None)
    logger = MetricLogger(str(tmp_path), "clipcap")
    for step, loss in ((1, 4.0), (2, 3.1), (3, 2.5)):
        logger.log(step, loss=loss, step_time=0.1)
    logger.close()
    out = tmp_path / "curves.png"
    visualize.main([logger.jsonl_path, "--keys", "loss", "step_time", "--out", str(out)])
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n" and f"wrote {out}" in capsys.readouterr().out


# ---- the host copies of the mT5 chain, the converters' slice and the chain ---------------

def _jax_app(monkeypatch, name, argv):
    """apps/<name>.py of the JAX package run as its __main__ in this process."""
    import contextlib
    import io
    import runpy

    monkeypatch.syspath_prepend(os.path.join(REPO, "apps"))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    with contextlib.redirect_stdout(io.StringIO()):
        runpy.run_path(os.path.join(REPO, "apps", f"{name}.py"), run_name="__main__")


def _caption_corpus(tmp_path):
    anns = [{"id": i, "caption": c, "violation_list": v, "file_name": f"{i}.jpg"}
            for i, (c, v) in enumerate([("工地邊緣未設置護欄", ""), ("", "開口未防護"),
                                        ("", ""), ("墜落 機械 物料", "x"), ("工地 開口", "")])]
    path = tmp_path / "all.json"
    path.write_text(json.dumps({"annotations": anns}, ensure_ascii=False), encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("key", ["caption", "violation_list"])
def test_json_to_text_writes_the_original_file(key, tmp_path, monkeypatch, capsys):
    """The port's json_to_text app against apps/json_to_text.py: the same lines
    (the --key field, else violation_list, empty ones skipped)."""
    from construction_clip_tpu_torch.apps import json_to_text

    corpus = _caption_corpus(tmp_path)
    json_to_text.main(["--json_path", corpus, "--out", str(tmp_path / "port.txt"), "--key", key])
    _jax_app(monkeypatch, "json_to_text",
             ["--json_path", corpus, "--out", str(tmp_path / "jax.txt"), "--key", key])
    got = (tmp_path / "port.txt").read_bytes()
    assert got == (tmp_path / "jax.txt").read_bytes()
    assert len(got.splitlines()) == {"caption": 4, "violation_list": 2}[key]
    assert "wrote" in capsys.readouterr().out


def test_train_tokenizer_writes_the_original_json(tmp_path, monkeypatch, capsys):
    """The port's train_tokenizer app against apps/train_tokenizer.py on the
    same text dump: the same tokenizers JSON, byte for byte."""
    from construction_clip_tpu_torch.apps import json_to_text, train_tokenizer

    txt = str(tmp_path / "text.txt")
    json_to_text.main(["--json_path", _caption_corpus(tmp_path), "--out", txt])
    argv = ["--input", txt, "--vocab_size", "200", "--min_frequency", "1"]
    train_tokenizer.main(argv + ["--out", str(tmp_path / "port.json")])
    _jax_app(monkeypatch, "train_tokenizer", argv + ["--out", str(tmp_path / "jax.json")])
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert json.loads(got)["model"]["type"] == "BPE" and "wrote" in capsys.readouterr().out


ZH_TEXTS = ["工地邊緣未設置護欄，有墜落之虞。", "開口未防護一樓 ○○ 樓梯", "a1 機械 123 物料/吊掛",
            "  ", "（鋼筋）「外露」─┼─ 施工架", "Hello 工地 x2", "作業人員未戴安全帽、未繫安全帶"]


def _without_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) \
                and ast.get_docstring(node) is not None:
            node.body = node.body[1:]
    return ast.dump(tree)


def _body(path, port):
    """The module's AST without docstrings, the port's package name read as
    the JAX package's."""
    src = open(path, encoding="utf-8").read()
    if port:
        src = src.replace("construction_clip_tpu_torch", "construction_clip_tpu")
    return _without_docstrings(ast.parse(src))


@pytest.mark.parametrize("name", ["report_parse", "etl", "corpus"])
def test_whole_host_copies_are_the_originals(name):
    """data/report_parse.py, data/etl.py and data/corpus.py are whole copies:
    the same code as the JAX package's, imports renamed, docstrings aside."""
    assert _body(os.path.join(REPO, "construction_clip_tpu_torch", "data", f"{name}.py"), True) \
        == _body(os.path.join(REPO, "construction_clip_tpu", "data", f"{name}.py"), False)


@pytest.mark.parametrize("cls", ["PairGroupDataset", "CaptionPairDataset", "FlickrDataset",
                                 "CocoCaptionDataset", "PrecomputedCaptionDataset",
                                 "OriginalClipCapDataset"])
def test_the_six_datasets_are_the_originals(cls):
    """Each of data/datasets.py's classes against the JAX module's, by its AST
    with docstrings dropped."""
    import inspect

    assert _without_docstrings(ast.parse(inspect.getsource(getattr(datasets, cls)))) == \
        _without_docstrings(ast.parse(inspect.getsource(getattr(j_datasets, cls))))


def test_tokenize_zh_and_its_filter_give_the_original_tokens():
    """data/corpus.py's copy: tokenize_zh, filter_tokens and the excluded
    punctuation, against construction_clip_tpu/data/corpus.py."""
    from construction_clip_tpu.data import corpus as j_corpus

    from construction_clip_tpu_torch.data import corpus

    assert corpus.EXCLUDE_PUNCTUATION == j_corpus.EXCLUDE_PUNCTUATION
    for text in ZH_TEXTS:
        assert corpus.tokenize_zh(text) == j_corpus.tokenize_zh(text)
    tokens = ["工地", "a工", "12", "工 地", "工、地", "", " ", "○", "機械"]
    assert corpus.filter_tokens(tokens) == j_corpus.filter_tokens(tokens) == ["工地", "機械"]


def test_fit_t5_vocab_gives_the_original_configs(capsys):
    """apps/common.py's tokenizer_vocab_size and fit_t5_vocab (the port's one
    copy, which predict_t5 and train_clipcap_t5 import) against the JAX apps'
    on tokenizers smaller than, equal to and larger than the vocab, and on
    objects that give their size by len() or not at all."""
    import dataclasses

    from construction_clip_tpu.core.configs import T5Config as JT5Config

    from construction_clip_tpu_torch.apps import common
    from construction_clip_tpu_torch.core.configs import T5Config

    j_common = _jax_common()

    class Sized:
        def __init__(self, n):
            self.n = n

        def vocab_size(self):
            return self.n

    class Lengthed(list):
        pass

    toks = [Sized(50), Sized(100), Sized(101), Sized(30000), Lengthed(range(300)), object()]
    for tok in toks:
        assert common.tokenizer_vocab_size(tok) == j_common.tokenizer_vocab_size(tok)
        for port_cfg, jax_cfg in ((T5Config.tiny(), JT5Config.tiny()), (T5Config(), JT5Config())):
            got = common.fit_t5_vocab(port_cfg, tok)
            assert dataclasses.asdict(got) == dataclasses.asdict(j_common.fit_t5_vocab(jax_cfg, tok))
    assert common.fit_t5_vocab(T5Config.tiny(), Sized(101)).vocab_size == 128
    capsys.readouterr()


def _jax_common():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_apps_common",
                                                  os.path.join(REPO, "apps", "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_product_e2e_synthesis_gives_the_original_images_and_subsets():
    """The chain's copies of synth_image and _round_robin_subset against
    tools/run_product_e2e.py's: the same pixels for each class and marker,
    and the same class-balanced subsets. A subset larger than the corpus is
    the whole corpus in the port (the JAX copy's loop never ends there, so
    it is not called with one)."""
    import run_product_e2e

    from construction_clip_tpu_torch.apps import product_e2e

    anns = [schema.Annotation(id=i, file_name=f"site/{i}.jpg", caption_type=ct,
                              violation_type=vt)
            for i, (ct, vt) in enumerate(
                [("violation", v) for v in labels.VIOLATION_TYPES] +
                [("status", "墜落"), ("status", "not a class"), ("violation", "")])]
    for a in anns:
        np.testing.assert_array_equal(product_e2e.synth_image(a), run_product_e2e.synth_image(a))
    raw = [{"id": a.id, "violation_type": a.violation_type} for a in anns] * 2
    for n in (1, 5, 12):
        assert product_e2e._round_robin_subset(anns, n) == \
            run_product_e2e._round_robin_subset(anns, n)
        key = (lambda r: r.get("violation_type", ""))
        assert product_e2e._round_robin_subset(raw, n, key=key) == \
            run_product_e2e._round_robin_subset(raw, n, key=key)
    assert product_e2e._round_robin_subset(anns, 40) == \
        run_product_e2e._round_robin_subset(anns, len(anns))


# ---- the detector's host copies, and the reference's quirks both packages keep -----------

@pytest.mark.parametrize("hw", [(256, 256), (480, 640), (301, 257), (1080, 1920), (40, 50),
                                (3, 900)])
@pytest.mark.parametrize("size", [800, 128])
def test_letterbox_gives_the_original_arrays(hw, size):
    img = (np.random.default_rng(hw[1]).random(hw + (3,)) * 255).astype(np.uint8)
    assert pipeline.letterbox_dims(*hw, size) == j_pipeline.letterbox_dims(*hw, size)
    got = pipeline.host_letterbox(img, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, j_pipeline.host_letterbox(img, size))


def _eval_inputs(seed):
    gen = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(4):
        gt = gen.uniform(0, 80, (3, 2))
        gt_boxes = np.concatenate([gt, gt + gen.uniform(5, 40, (3, 2))], axis=1)
        gt_labels = gen.integers(1, 4, 3)
        jitter = gen.normal(0, 3, (5, 4))
        boxes = np.concatenate([gt_boxes, gt_boxes[:2]]) + jitter
        labels = np.concatenate([gt_labels, gen.integers(1, 4, 2)])
        preds.append({"boxes": boxes, "labels": labels, "scores": gen.random(5)})
        gts.append({"boxes": gt_boxes, "labels": gt_labels})
    return preds, gts


def test_detection_eval_gives_the_original_metrics():
    """infer/detection_eval.py's copy: the metrics, the AP of a curve, the
    eval format of fixed-slot detections and the centre-square clip."""
    from construction_clip_tpu.infer import detection_eval as j_eval

    from construction_clip_tpu_torch.infer import detection_eval

    assert detection_eval.IOU_THRESHOLDS == j_eval.IOU_THRESHOLDS
    for seed in (0, 1):
        preds, gts = _eval_inputs(seed)
        for nc in (4, 6):
            assert detection_eval.evaluate_detections(preds, gts, num_classes=nc) == \
                j_eval.evaluate_detections(preds, gts, num_classes=nc)
    rec, prec = np.asarray([0.1, 0.4, 0.4, 0.9]), np.asarray([1.0, 0.5, 0.7, 0.3])
    assert detection_eval.average_precision(rec, prec) == j_eval.average_precision(rec, prec)

    class Det:
        boxes = np.arange(12, dtype=np.float32).reshape(3, 4)
        labels = np.asarray([2, 1, 0])
        scores = np.asarray([0.9, 0.2, 0.0], np.float32)

    got, want = detection_eval.detections_to_eval_format(Det, min_score=0.1), \
        j_eval.detections_to_eval_format(Det, min_score=0.1)
    for k in ("boxes", "labels", "scores"):
        np.testing.assert_array_equal(got[k], want[k])
    boxes = [[0, 0, 50, 50], [100, 10, 150, 60], [-5, 0, 30, 20], [60, 60, 90, 95]]
    for h, w in ((100, 200), (200, 100), (100, 100)):
        assert detection_eval.clip_gt_to_center_square(boxes, [1, 2, 3, 4], h, w) == \
            j_eval.clip_gt_to_center_square(boxes, [1, 2, 3, 4], h, w)


class _RawDetector:
    """A raw detector that answers fixed detections of every label 0..7."""
    image_size = 64
    geometry = "letterbox"

    def __init__(self):
        self.staged = []

    def detect(self, image_u8):
        return {"boxes": [[i, i, i + 5.0, i + 6.0] for i in range(8)],
                "labels": list(range(8)), "scores": [0.5 + 0.06 * i for i in range(8)]}

    def detect_batch(self, staged_u8, sizes):
        return [self.detect(None) for _ in sizes]

    def stage(self, image_u8):
        self.staged.append(image_u8)
        return "staged by the inner detector"


def test_null_detector_and_threshold_wrapper_give_the_original_dicts():
    from construction_clip_tpu.serve import detector as j_detector

    from construction_clip_tpu_torch.serve import detector

    img = np.zeros((10, 12, 3), np.uint8)
    assert detector.NullDetector().detect(img) == j_detector.NullDetector().detect(img)
    assert detector.NullDetector().detect_batch(None, [(1, 2)] * 3) == \
        j_detector.NullDetector().detect_batch(None, [(1, 2)] * 3)
    for threshold in (0.0, 0.7, 0.8):
        port = detector.ThresholdWrapper(_RawDetector(), threshold=threshold)
        orig = j_detector.ThresholdWrapper(_RawDetector(), threshold=threshold)
        assert port.detect(img) == orig.detect(img)
        assert port.detect_batch(None, [(1, 2)] * 2) == orig.detect_batch(None, [(1, 2)] * 2)
        assert (port.image_size, port.geometry) == (orig.image_size, orig.geometry) == \
            (64, "letterbox")
    assert port.detect(img)["labels"] == ["模板", "施工架", "人員"]   # labels 5-7 at 0.8


def test_a_seven_class_head_never_emits_the_eighth_name():
    """DETECTOR_CLASSES has 8 names, serving defaults to 7 classes (the
    reference head) and eval to 8, in both packages: a 7-class head's labels
    are 0..6, so label 7 ("人員") is never emitted. Both detectors on one
    7-class tree at 64 px, every slot live at threshold 0."""
    import inspect

    import jax
    import jax.numpy as jnp

    from construction_clip_tpu.models import detection as j_det
    from construction_clip_tpu.serve import detector as j_detector

    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.apps import eval_detection
    from construction_clip_tpu_torch.models import detection as t_det
    from construction_clip_tpu_torch.serve import detector

    assert len(labels.DETECTOR_CLASSES) == len(j_labels.DETECTOR_CLASSES) == 8
    for cls in (detector.TorchDetector, j_detector.JaxDetector):
        assert inspect.signature(cls).parameters["num_classes"].default == 7
    assert eval_detection.parse_args(["--json_path", "x"]).num_classes == 8
    tree = convert.init_fasterrcnn(7, num_classes=7)
    img = np.random.default_rng(7).random((64, 64, 3)).astype(np.float32)
    kw = dict(image_size=64, num_classes=7, pre_nms_topk=50, post_nms_topk=20,
              detections_per_img=30, score_thresh=0.0)
    got = t_det.fasterrcnn_infer(convert.to_detector_params(tree), torch.from_numpy(img)[None],
                                 **kw).labels[0].numpy()
    want = np.asarray(jax.jit(j_det.fasterrcnn_infer, static_argnames=tuple(kw))(
        tree, jnp.asarray(img), **kw).labels)
    for lab in (got, want):
        assert lab.max() <= 6 and (lab > 0).any()
    wrapped = [detector.ThresholdWrapper(_RawDetector(), threshold=0.0),
               j_detector.ThresholdWrapper(_RawDetector(), threshold=0.0)]
    names = [set(w._apply({"boxes": [[0, 0, 1, 1]] * len(got), "labels": [int(v) for v in got],
                           "scores": [1.0] * len(got)})["labels"]) for w in wrapped]
    assert names[0] == names[1] and "人員" not in names[0]


def test_threshold_wrapper_stage_passes_straight_to_the_inner_detector():
    """ThresholdWrapper.stage delegates without any check in both packages:
    the inner detector's answer comes back as it is, whatever it is, and an
    inner detector without stage() raises AttributeError."""
    from construction_clip_tpu.serve import detector as j_detector

    from construction_clip_tpu_torch.serve import detector

    img = np.ones((5, 7, 3), np.uint8)
    for mod in (detector, j_detector):
        inner = _RawDetector()
        assert mod.ThresholdWrapper(inner).stage(img) == "staged by the inner detector"
        assert inner.staged[0] is img
        with pytest.raises(AttributeError):
            mod.ThresholdWrapper(mod.NullDetector()).stage(img)


def test_eval_scores_a_band_object_under_letterbox_as_jax():
    """eval_detection stages by letterbox but clips ground truth to the
    centre square: on a 100 x 300 image an object in the left band is
    excluded from the ground truth, and the detection of it, which the
    letterbox staging lets the detector make, is a false positive, in both
    packages alike (the port's evaluate_image against the JAX app's loop)."""
    from construction_clip_tpu.infer import detection_eval as j_eval

    from construction_clip_tpu_torch.apps import eval_detection
    from construction_clip_tpu_torch.infer import detection_eval

    band, centre = [10.0, 20.0, 60.0, 80.0], [120.0, 10.0, 180.0, 90.0]

    class Letterboxed:
        def detect(self, image_u8):
            return {"boxes": [band, centre], "labels": [2, 1], "scores": [0.9, 0.8]}

    ann = {"boxes": [band, centre], "labels": [2, 1]}
    img = np.zeros((100, 300, 3), np.uint8)
    pred, gt, n_out = eval_detection.evaluate_image(Letterboxed(), img, ann)
    j_boxes, j_labels, j_out = j_eval.clip_gt_to_center_square(ann["boxes"], ann["labels"],
                                                               100, 300)
    assert (gt, n_out) == ({"boxes": j_boxes, "labels": j_labels}, j_out) and n_out == 1
    got = detection_eval.evaluate_detections([pred], [gt], num_classes=3)
    assert got == j_eval.evaluate_detections([pred], [{"boxes": j_boxes, "labels": j_labels}],
                                             num_classes=3)
    assert got["per_class"] == {1: 1.0} and got["AP50"] == 1.0   # class 2: no ground truth left
