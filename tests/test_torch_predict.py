"""PyTorch port, batch captioning and scoring against the JAX package (CPU,
fp32): GPT-2 positions past its table, and the product chain's stages 2-5 end
to end on a PIL-written corpus: the port's parse_corpus and train_clipcap,
then the JAX package's apps/predict.py and the port's predict on the same
checkpoints (greedy and beam: equal output_log.json records), and both
packages' score apps (equal JSON). The JAX apps run in this process
(`runpy`, sys.argv patched), not in subprocesses."""

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


def test_predict_refuses_what_is_not_ported():
    from construction_clip_tpu_torch.apps import predict

    for flag in ("--explain", "--attention_maps"):
        with pytest.raises(NotImplementedError, match="item 5"):
            predict.main(["--device", "cpu", flag])
    for flags in (["--suspect_retries", "2"], ["--suspect_backoff", "300"]):
        with pytest.raises(NotImplementedError, match="item 7"):
            predict.main(["--device", "cpu", *flags])
    assert predict.parse_args([]).suspect_retries == 0


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
