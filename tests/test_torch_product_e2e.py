"""The port's product chain (apps/product_e2e.py, the counterpart of
tools/run_product_e2e.py) on a synthetic corpus at test scale, on the CPU:
stages 7-11 (the mT5 workflow) in this process, and the whole 11-stage chain
in subprocesses (slow, as tests/test_product_e2e.py runs the JAX chain).
The reference corpus is not in the repo: the tests write captions of the
construction-safety vocabulary over the 9 violation classes."""

import json

import numpy as np
import pytest

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.apps import product_e2e
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.data.labels import VIOLATION_TYPES

WORDS = ["工地", "邊緣", "未設置", "護欄", "開口", "墜落", "機械", "物料", "吊掛", "作業",
         "人員", "安全帽", "施工架", "鋼筋", "外露", "防護"]
T5_STAGES = ["json_to_text", "train_tokenizer", "train_clipcap_t5", "predict_t5", "score_t5"]


def _corpus(path, n: int, seed: int = 0) -> str:
    """n annotations round the 9 violation classes, each with a caption of 3-6
    construction words and a violation list."""
    gen = np.random.default_rng(seed)
    anns = []
    for i in range(n):
        words = gen.choice(WORDS, size=int(gen.integers(3, 7)))
        anns.append({"id": i, "file_name": f"site/{i}.jpg",
                     "caption_type": "violation" if i % 3 else "status",
                     "violation_type": VIOLATION_TYPES[i % len(VIOLATION_TYPES)],
                     "violation_list": "".join(words[:2]), "caption": "".join(words),
                     "objects": ""})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"type": "captions", "annotations": anns}, f, ensure_ascii=False)
    return str(path)


def test_t5_stages_run_in_process_on_a_tiny_corpus(tmp_path, monkeypatch):
    """Stages 7-11 on 6 annotations (4 train, 2 held out), --t5_size tiny, in
    this process: stage 9 reads the prefix archive that stage 2 would write
    (made here from the train split's captions) and stage 10 the CLIP
    checkpoint of stage 1 (random tiny_bpe weights). The t5 loss curve must
    drop 2% below its start, both held-out images get a caption, and the
    captions are scored."""
    from construction_clip_tpu_torch.train.checkpoint import save_params_npz

    for mod in ("torch.utils.tensorboard", "tensorboardX"):
        monkeypatch.setitem(__import__("sys").modules, mod, None)
    corpus = _corpus(tmp_path / "all.json", 6)
    wd = tmp_path / "e2e"
    (wd / "models").mkdir(parents=True)
    cfg = CLIPConfig.tiny_bpe()
    save_params_npz(str(wd / "models" / "clip_latest.npz"),
                    convert.to_params(convert.init_clip(0, cfg)))
    with open(corpus, encoding="utf-8") as f:
        train = json.load(f)["annotations"][:4]
    gen = np.random.default_rng(1)
    np.savez(wd / "embedding.npz",
             embeddings=gen.standard_normal((4, cfg.text.embed_dim)).astype(np.float32),
             attributes=np.asarray(["缺失 墜落 "] * 4, dtype=object),
             captions=np.asarray([a["caption"] for a in train], dtype=object))
    product_e2e.main(["--corpus", corpus, "--workdir", str(wd), "--arch", "tiny_bpe",
                      "--t5_size", "tiny", "--t5_epochs", "30", "--cap_bs", "4",
                      "--cap_lr", "1e-3", "--warmup", "2", "--predict_bs", "2",
                      "--device", "cpu", "--in_process",
                      "--stages", ",".join(T5_STAGES)])
    summary = json.loads((wd / "summary.json").read_text(encoding="utf-8"))
    assert summary["ok"] and summary["losses_decreased"], summary
    assert [s["stage"] for s in summary["stages"]] == T5_STAGES
    assert all(s["rc"] == 0 for s in summary["stages"])
    curve = summary["t5_loss"]
    assert curve["n"] == 30 and curve["min"] < 0.98 * curve["first"][1], curve
    assert summary["t5_n_predictions"] == 2
    assert summary["t5_score"]["n"] == 2 and 0 <= summary["t5_score"]["bleu"] <= 1
    for rel in ("text.txt", "assets/chinese_bpe.json", "models/t5_prefix.npz",
                "output/output_t5.json"):
        assert (wd / rel).exists(), rel
    records = json.loads((wd / "output" / "output_t5.json").read_text(encoding="utf-8"))
    assert [set(r) for r in records] == [{"id", "file_name", "attribute", "caption",
                                         "ground_truth_caption"}] * 2


def test_a_failed_stage_stops_the_chain_and_is_recorded(tmp_path, monkeypatch):
    """Stage 9 without its prefix archive fails: the chain exits naming the
    stage, and summary.json records it with ok false and a nonzero rc."""
    corpus = _corpus(tmp_path / "all.json", 6)
    wd = tmp_path / "e2e"
    with pytest.raises(SystemExit, match="stage train_clipcap_t5 failed"):
        product_e2e.main(["--corpus", corpus, "--workdir", str(wd), "--arch", "tiny_bpe",
                          "--t5_size", "tiny", "--device", "cpu", "--in_process",
                          "--stages", "json_to_text,train_tokenizer,train_clipcap_t5"])
    summary = json.loads((wd / "summary.json").read_text(encoding="utf-8"))
    assert not summary["ok"]
    assert [(s["stage"], s["rc"] != 0) for s in summary["stages"]] == [
        ("json_to_text", False), ("train_tokenizer", False), ("train_clipcap_t5", True)]
    assert "FileNotFoundError" in open(summary["stages"][-1]["log"], encoding="utf-8").read()


@pytest.mark.slow
def test_whole_chain_on_the_port(tmp_path):
    """All 11 stages through the port's apps in subprocesses, on the CPU at
    tiny size (48 annotations over the 9 classes): every stage succeeds, the
    three loss curves drop 2% below their starts, and both decoders' held-out
    captions are scored."""
    corpus = _corpus(tmp_path / "all.json", 60)
    wd = tmp_path / "e2e"
    product_e2e.main(["--corpus", corpus, "--workdir", str(wd), "--arch", "tiny_bpe",
                      "--gpt_size", "tiny", "--t5_size", "tiny", "--subset", "48",
                      "--clip_epochs", "3", "--cap_epochs", "6", "--t5_epochs", "30",
                      "--clip_groups_per_batch", "1", "--cap_bs", "8", "--warmup", "4",
                      "--device", "cpu"])
    summary = json.loads((wd / "summary.json").read_text(encoding="utf-8"))
    assert summary["ok"] and summary["losses_decreased"], summary
    assert [s["stage"] for s in summary["stages"]] == product_e2e.STAGE_ORDER
    assert summary["n_predictions"] >= 8 and summary["t5_n_predictions"] >= 8
    assert summary["score"]["n"] > 0 and summary["t5_score"]["n"] > 0
    for rel in ("models/clip_latest.npz", "embedding.npz", "models/clipcap.npz",
                "output/output_log.json", "curves.png", "models/t5_prefix.npz",
                "output/output_t5.json"):
        assert (wd / rel).exists(), rel
