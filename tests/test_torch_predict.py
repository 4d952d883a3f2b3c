"""PyTorch port, batch captioning and scoring against the JAX package (CPU,
fp32): GPT-2 positions past its table, and the product chain's stages 2-5 end
to end on a PIL-written corpus: the port's parse_corpus and train_clipcap,
then the JAX package's apps/predict.py and the port's predict on the same
checkpoints (greedy and beam: equal output_log.json records), and both
packages' score apps (equal JSON); then predict's --explain and
--attention_maps files, its re-run of decode_suspect rows and its
transformer mapper, each against the JAX app. The JAX apps run in this
process (`runpy`, sys.argv patched), not in subprocesses."""

import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from construction_clip_tpu.infer import decode as jdecode
from construction_clip_tpu.models import gpt2 as jgpt2
from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.core.configs import CLIPConfig, GPT2Config
from construction_clip_tpu_torch.data import offline_assets
from construction_clip_tpu_torch.infer import decode
from construction_clip_tpu_torch.models import gpt2
from construction_clip_tpu_torch.train.checkpoint import save_params_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GCFG = GPT2Config.tiny()


def test_positions_past_the_table_take_its_last_row_as_jax():
    """A prompt of 60 positions and 10 greedy steps on GPT2Config.tiny() (64
    positions): the JAX package's gather clamps the positions past the table
    to its last row, and so does the port (it raised before). That is the
    predict app's tiny config: prefix 20 + attribute 20 + up to 100 steps."""
    jparams = jgpt2.init_gpt2(jax.random.key(5), GCFG)
    emb = np.random.default_rng(3).standard_normal((2, 60, GCFG.n_embd)).astype(np.float32)
    want = jdecode.greedy_decode(jparams, GCFG, jnp.asarray(emb), max_steps=10,
                                 stop_token=-1)
    got = decode.greedy_decode(convert.to_params(jparams).tree(), GCFG, torch.from_numpy(emb),
                               max_steps=10, stop_token=-1)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    wpe = torch.arange(64.0)[:, None]
    assert gpt2._position_embeddings(wpe, 62, 4)[:, 0].tolist() == [62, 63, 63, 63]
    assert gpt2._position_embeddings(wpe, 3, 2)[:, 0].tolist() == [3, 4]


# ---- the chain -----------------------------------------------------------------------------

N_IMAGES = 24
CHARS = "墜落機械物料感電防護工作場所"


def _corpus(root):
    """N_IMAGES annotations over PIL-written JPEGs of mixed sizes, the assets (a
    6-merge CLIP BPE for tiny_bpe, a 128-entry BERT vocab for the tiny GPT-2)
    and a tiny_bpe CLIP checkpoint of the port's init, which both packages
    read."""
    from PIL import Image

    gen = np.random.default_rng(8)
    vts = ["墜落", "機械", "物料", "感電"]
    anns = []
    for i in range(N_IMAGES):
        fn = f"site{i}.jpg"
        hw = [(40, 48), (64, 64), (30, 70)][i % 3]
        Image.fromarray((gen.random(hw + (3,)) * 255).astype(np.uint8)).save(root / fn)
        cap = "".join(gen.choice(list(CHARS), size=int(gen.integers(3, 9))))
        anns.append({"id": i, "caption_type": ["violation", "status"][i % 2],
                     "violation_type": vts[i % 4], "violation_list": f"列{i}",
                     "caption": cap if i % 5 else "", "file_name": fn, "objects": ""})
    (root / "all.json").write_text(json.dumps({"type": "captions", "annotations": anns},
                                              ensure_ascii=False), encoding="utf-8")
    offline_assets.write_clip_merges(str(root / "merges.txt.gz"), n_merges=6)
    (root / "vocab").mkdir()
    # the 24 characters a 128-entry vocab holds: the captions' first
    offline_assets.write_bert_vocab(str(root / "vocab" / "vocab.txt"), list(dict.fromkeys(
        CHARS + "".join(offline_assets.corpus_characters([])))), size=128)
    save_params_npz(str(root / "clip.npz"),
                    convert.to_params(convert.init_clip(0, CLIPConfig.tiny_bpe())))


def _jax_app(monkeypatch, name, argv):
    """apps/<name>.py of the JAX package run as its __main__ in this process;
    returns what it printed."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "apps"))
    monkeypatch.setattr(sys, "argv", [name] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(REPO, "apps", f"{name}.py"), run_name="__main__")
    return out.getvalue()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Stages 2-3 on the port: parse_corpus, then train_clipcap (full
    fine-tune, fp32, 2 epochs)."""
    from construction_clip_tpu_torch.apps import parse_corpus, train_clipcap

    root = tmp_path_factory.mktemp("chain")
    _corpus(root)
    with pytest.MonkeyPatch.context() as mp:
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            mp.setitem(sys.modules, mod, None)
        with contextlib.redirect_stdout(io.StringIO()):
            parse_corpus.main(["--json_path", str(root / "all.json"),
                               "--image_root", str(root), "--checkpoint", str(root / "clip.npz"),
                               "--clip_bpe", str(root / "merges.txt.gz"), "--arch", "tiny_bpe",
                               "--out", str(root / "emb.npz"), "--device", "cpu"])
            train_clipcap.main(["--data", str(root / "emb.npz"), "--out_dir", str(root / "m"),
                                "--prefix", "clipcap", "--epochs", "2", "--save_every", "2",
                                "--bs", "4", "--lr", "3e-3", "--warmup_steps", "0",
                                "--gpt_size", "tiny", "--tokenizer", str(root / "vocab"),
                                "--log_dir", str(root / "log"), "--device", "cpu",
                                "--precision", "fp32"])
    return root


def _predict_argv(root, out, beam):
    return ["--json_path", str(root / "all.json"), "--image_root", str(root),
            "--clip_checkpoint", str(root / "clip.npz"), "--arch", "tiny_bpe",
            "--caption_checkpoint", str(root / "m" / "clipcap.npz"),
            "--clip_bpe", str(root / "merges.txt.gz"), "--tokenizer", str(root / "vocab"),
            "--batch_size", "5", "--policy", "fp32", "--output_dir", str(out),
            "--suspect_retries", "0", *([] if beam else ["--greedy"])]


def test_chain_train_clipcap_writes_what_predict_reads(chain):
    """train_clipcap's npz holds {mapper, gpt} at the tiny config's shapes;
    its loss log has a point an epoch."""
    with np.load(chain / "m" / "clipcap.npz") as data:
        assert data["mapper/w1"].shape == (32, 20 * GCFG.n_embd // 2)
        assert data["gpt/wte"].shape == (GCFG.vocab_size, GCFG.n_embd)
    logs = [json.loads(line) for line in open(chain / "log" / "clipcap.jsonl")]
    assert [r["step"] for r in logs] == [6, 12] and all(np.isfinite(r["loss"]) for r in logs)


@pytest.mark.parametrize("beam", [False, True], ids=["greedy", "beam"])
def test_chain_predict_records_equal_the_jax_apps(beam, chain, monkeypatch, capsys):
    """JAX's apps/predict.py and the port's predict on the port's npz, fp32:
    the same output_log.json records (every key, captions and decode_suspect
    included); then both score apps print the same JSON for the port's log."""
    from construction_clip_tpu_torch.apps import predict, score

    name = "beam" if beam else "greedy"
    _jax_app(monkeypatch, "predict", _predict_argv(chain, chain / f"jax_{name}", beam))
    with contextlib.redirect_stdout(io.StringIO()):
        predict.main(_predict_argv(chain, chain / f"port_{name}", beam) + ["--device", "cpu"])
    logs = {side: json.loads((chain / f"{side}_{name}" / "output_log.json").read_text(
        encoding="utf-8")) for side in ("jax", "port")}
    assert len(logs["port"]) == N_IMAGES
    assert any(r["caption"] for r in logs["port"])   # text, not only special tokens
    assert logs["port"] == logs["jax"]
    assert list(logs["port"][0]) == ["id", "file_name", "ground_truth_caption",
                                     "ground_truth_attribute", "caption", "attribute",
                                     "caption_type", "violation_type", "decode_suspect"]
    log = str(chain / f"port_{name}" / "output_log.json")
    capsys.readouterr()
    score.main([log])
    port_score = json.loads(capsys.readouterr().out)
    jax_score = json.loads(_jax_app(monkeypatch, "score", [log]))
    assert port_score == jax_score and port_score["n"] == sum(
        1 for r in logs["port"] if r["ground_truth_caption"])


def test_predict_policy_auto_is_bf16_on_the_card_and_fp32_on_the_cpu():
    from construction_clip_tpu_torch.apps.predict import resolve_policy
    from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY

    assert resolve_policy("auto", torch.device("cuda")) is BF16_POLICY
    assert resolve_policy("auto", torch.device("cpu")) is DEFAULT_POLICY
    assert resolve_policy("fp32", torch.device("cuda")) is DEFAULT_POLICY
    assert resolve_policy("bf16", torch.device("cpu")) is BF16_POLICY


def test_predict_plots_write_a_figure_per_image(chain):
    """--plots: an annotated PNG a record, matplotlib and PIL imported when
    the app plots."""
    from construction_clip_tpu_torch.apps import predict

    out = chain / "plots"
    with contextlib.redirect_stdout(io.StringIO()):
        predict.main(_predict_argv(chain, out, False) + ["--device", "cpu", "--plots"])
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert len(pngs) == N_IMAGES and all((out / f).stat().st_size > 0 for f in pngs)


# ---- explainability, the decode_suspect re-run, the transformer mapper --------------------

def _subset(root, n, name):
    """The first n annotations of the chain's corpus, as a corpus file."""
    data = json.loads((root / "all.json").read_text(encoding="utf-8"))
    data["annotations"] = data["annotations"][:n]
    (root / name).write_text(json.dumps(data, ensure_ascii=False), encoding="utf-8")
    return str(root / name)


def _argv(root, json_path, out, caption_checkpoint, *extra):
    return ["--json_path", json_path, "--image_root", str(root),
            "--clip_checkpoint", str(root / "clip.npz"), "--arch", "tiny_bpe",
            "--caption_checkpoint", caption_checkpoint, "--clip_bpe", str(root / "merges.txt.gz"),
            "--tokenizer", str(root / "vocab"), "--batch_size", "2", "--policy", "fp32",
            "--output_dir", str(out), "--greedy", *extra]


def test_predict_explain_and_attention_maps_equal_the_jax_apps(chain, monkeypatch):
    """--explain --attention_maps on 3 images, fp32: the port writes the files
    the JAX app writes (a relevance PNG of the staged image's shape, an HTML
    heatmap equal to JAX's, an attention figure per image), the overlays
    within 2 levels of 255 of JAX's (R within 1e-5, rounded to 8 bits), the
    attention rows (captured on their way to the figure) within 1e-5 of
    JAX's, each row a distribution, and the records equal. Both pipelines'
    captions are cut to 6 characters: the JAX package's decoder attention map
    runs eagerly, where a position past tiny GPT-2's 64-row table raises
    (prompt 40 + caption; its jitted decode clamps, as the port does always)."""
    from PIL import Image

    from construction_clip_tpu.infer import explain as jexplain
    from construction_clip_tpu.infer.caption import CaptionPipeline as JPipeline
    from construction_clip_tpu_torch.apps import predict
    from construction_clip_tpu_torch.infer import explain
    from construction_clip_tpu_torch.infer.caption import CaptionPipeline

    for cls in (JPipeline, CaptionPipeline):
        _cut_captions(cls, monkeypatch)

    rows = {"jax": [], "port": []}
    for side, mod in (("jax", jexplain), ("port", explain)):
        plot = mod.plot_attention_map

        def capture(attn_rows, out_path, token_labels=None, side=side, plot=plot):
            rows[side].append((os.path.basename(out_path), np.asarray(attn_rows),
                               list(token_labels)))
            plot(attn_rows, out_path, token_labels=token_labels)

        monkeypatch.setattr(mod, "plot_attention_map", capture)
    json_path = _subset(chain, 3, "explain.json")
    npz = str(chain / "m" / "clipcap.npz")
    flags = ("--explain", "--attention_maps", "--suspect_retries", "0")
    _jax_app(monkeypatch, "predict", _argv(chain, json_path, chain / "jax_explain", npz, *flags))
    with contextlib.redirect_stdout(io.StringIO()):
        predict.main(_argv(chain, json_path, chain / "port_explain", npz, *flags,
                           "--device", "cpu"))
    files = {side: sorted(os.listdir(chain / f"{side}_explain")) for side in ("jax", "port")}
    assert files["port"] == files["jax"]
    assert sum(f.endswith(".relevance.png") for f in files["port"]) == 3
    assert sum(f.endswith(".attn.png") for f in files["port"]) == len(rows["port"]) == 3
    for f in files["port"]:
        port, jax_ = chain / "port_explain" / f, chain / "jax_explain" / f
        if f.endswith(".html") or f.endswith(".json"):
            assert port.read_text(encoding="utf-8") == jax_.read_text(encoding="utf-8"), f
        elif f.endswith(".relevance.png"):
            with Image.open(port) as a, Image.open(jax_) as b:
                a, b = np.asarray(a, np.int16), np.asarray(b, np.int16)
            assert a.shape == b.shape == (256, 256, 3)
            assert np.abs(a - b).max() <= 2, f
    for (name_p, got, labels_p), (name_j, want, labels_j) in zip(rows["port"], rows["jax"]):
        assert name_p == name_j and labels_p == labels_j
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_make_explain_returns_the_arrays_main_writes(chain):
    """The batch function on staged uint8 arrays, without PIL or files: an
    overlay of the staged shape, per-character scores, attention rows and
    token labels for each record; fp32 relevance from a bf16 pipeline."""
    from construction_clip_tpu_torch.apps import predict
    from construction_clip_tpu_torch.apps.common import TokenizerFile, load_clip_tokenizer
    from construction_clip_tpu_torch.core.configs import ClipCapConfig
    from construction_clip_tpu_torch.core.precision import BF16_POLICY
    from construction_clip_tpu_torch.data.schema import Annotation
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    clip_cfg = CLIPConfig.tiny_bpe()
    ccfg = ClipCapConfig(clip_dim=clip_cfg.text.embed_dim)
    clip_tree = convert.init_clip(0, clip_cfg)
    cap_tree = load_params_npz(str(chain / "m" / "clipcap.npz"),
                               convert.init_clipcap(convert.SHAPES, ccfg, GCFG))
    clip_tok = load_clip_tokenizer(str(chain / "merges.txt.gz"))
    process = predict.make_process(
        convert.to_params(clip_tree, dtype=torch.bfloat16), clip_cfg,
        convert.to_params(cap_tree, dtype=torch.bfloat16), ccfg, GCFG, clip_tok,
        TokenizerFile(str(chain / "vocab")), use_beam=False, policy=BF16_POLICY, device="cpu")
    process.pipe.max_steps = 30   # prompt 40 + 30 steps: positions past the 64-row table
    explain = predict.make_explain(process.pipe, convert.to_params(clip_tree),
                                   convert.to_params(cap_tree["gpt"]), device="cpu")
    staged = (np.random.default_rng(0).random((2, 64, 64, 3)) * 255).astype(np.uint8)
    with contextlib.redirect_stdout(io.StringIO()):
        records = process([Annotation(id=i, file_name=f"{i}.jpg") for i in range(2)], staged)
    items = explain(staged, records)
    assert len(items) == 2
    for rec, item in zip(records, items):
        assert item["overlay"].shape == (64, 64, 3) and item["overlay"].dtype == np.uint8
        text = rec["caption"] or rec["attribute"]
        assert [c for c, _ in item["char_scores"]] == list(text)[:len(item["char_scores"])]
        assert item["attention"].dtype == np.float32
        assert item["attention"].shape[0] == len(item["labels"])
        np.testing.assert_allclose(item["attention"].sum(-1), 1.0, rtol=1e-5)
    with pytest.raises(ValueError, match="square"):
        explain(staged[:, :, :60], records)


def _cut_captions(cls, monkeypatch, n=6):
    """cls.caption_images with every caption cut to its first n characters."""
    original = cls.caption_images

    def caption_images(self, *args, **kwargs):
        return [dict(r, caption=r["caption"][:n]) for r in original(self, *args, **kwargs)]

    monkeypatch.setattr(cls, "caption_images", caption_images)


def _flag_row_once(cls, monkeypatch):
    """cls.caption_images, with the first call's first row flagged
    decode_suspect, as a collapsed row would be."""
    original, calls = cls.caption_images, []

    def caption_images(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        if not calls:
            out[0] = dict(out[0], caption="", decode_suspect=True)
        calls.append(len(out))
        return out

    monkeypatch.setattr(cls, "caption_images", caption_images)
    return calls


def test_predict_reruns_decode_suspect_rows_as_the_jax_app(chain, monkeypatch):
    """A pipeline that flags one row once: after --suspect_backoff 0 both apps
    caption that row again, alone, and write equal records with the flag
    cleared."""
    from construction_clip_tpu.infer.caption import CaptionPipeline as JPipeline
    from construction_clip_tpu_torch.apps import predict
    from construction_clip_tpu_torch.infer.caption import CaptionPipeline

    json_path = _subset(chain, 4, "suspect.json")
    npz = str(chain / "m" / "clipcap.npz")
    flags = ("--suspect_retries", "2", "--suspect_backoff", "0")
    jcalls = _flag_row_once(JPipeline, monkeypatch)
    jout = _jax_app(monkeypatch, "predict", _argv(chain, json_path, chain / "jax_sus", npz,
                                                  *flags))
    tcalls = _flag_row_once(CaptionPipeline, monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        predict.main(_argv(chain, json_path, chain / "port_sus", npz, *flags, "--device", "cpu"))
    assert jcalls == tcalls == [2, 2, 1]   # two batches, then the flagged row alone
    assert "retry 1/2" in jout and "retry 1/2" in out.getvalue()
    logs = {side: json.loads((chain / f"{side}_sus" / "output_log.json").read_text(
        encoding="utf-8")) for side in ("jax", "port")}
    assert logs["port"] == logs["jax"]
    assert not any(r["decode_suspect"] for r in logs["port"]) and logs["port"][0]["caption"]


def test_predict_with_the_transformer_mapper_equals_the_jax_app(chain, monkeypatch):
    """The port's train_clipcap --mapping_type transformer at the clip length
    predict builds (--prefix_length_clip 10; 8 blocks), then both predict
    apps with --mapping_type transformer on its npz, greedy: equal records."""
    from construction_clip_tpu_torch.apps import predict, train_clipcap

    with pytest.MonkeyPatch.context() as mp:
        for mod in ("torch.utils.tensorboard", "tensorboardX"):
            mp.setitem(sys.modules, mod, None)
        with contextlib.redirect_stdout(io.StringIO()):
            train_clipcap.main(["--data", str(chain / "emb.npz"), "--out_dir", str(chain / "t"),
                                "--prefix", "tmap", "--epochs", "1", "--bs", "4",
                                "--lr", "3e-3", "--warmup_steps", "0", "--gpt_size", "tiny",
                                "--tokenizer", str(chain / "vocab"),
                                "--log_dir", str(chain / "tlog"), "--device", "cpu",
                                "--precision", "fp32", "--mapping_type", "transformer",
                                "--prefix_length_clip", "10"])
    json_path = _subset(chain, 6, "tmap.json")
    npz = str(chain / "t" / "tmap.npz")
    flags = ("--mapping_type", "transformer", "--suspect_retries", "0")
    _jax_app(monkeypatch, "predict", _argv(chain, json_path, chain / "jax_tmap", npz, *flags))
    with contextlib.redirect_stdout(io.StringIO()):
        predict.main(_argv(chain, json_path, chain / "port_tmap", npz, *flags, "--device", "cpu"))
    logs = {side: json.loads((chain / f"{side}_tmap" / "output_log.json").read_text(
        encoding="utf-8")) for side in ("jax", "port")}
    assert len(logs["port"]) == 6 and logs["port"] == logs["jax"]
