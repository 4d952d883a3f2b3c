"""The product chain on the port (the counterpart of tools/run_product_e2e.py): the
reference's workflow driven through the port's own apps, each stage reading the
previous stage's artifact with no hand edits.

  stage 1  train_clip         contrastive fine-tune, loss curve recorded
  stage 2  parse_corpus       embeddings + zero-shot attributes from the tuned
                              CLIP (train split)
  stage 3  train_clipcap      ClipCap (GPT-2) caption training
  stage 4  predict            beam-3 captions for the held-out split
  stage 5  score              char-BLEU + ROUGE against the real captions
  stage 6  visualize          loss curves PNG
  stage 7  json_to_text       caption text dump of the train split
  stage 8  train_tokenizer    BPE tokenizer trained on that dump
  stage 9  train_clipcap_t5   mT5 caption training on stage 2's embeddings
  stage 10 predict_t5         greedy mT5 captions for the held-out split
  stage 11 score_t5           char-BLEU + ROUGE of the mT5 captions

    python -m construction_clip_tpu_torch.apps.product_e2e --corpus all.json \\
        --workdir runs/e2e_torch
    python -m construction_clip_tpu_torch.apps.product_e2e --corpus all.json \\
        --workdir /tmp/e2e --arch tiny_bpe --gpt_size tiny --t5_size tiny \\
        --subset 48 --clip_epochs 2 --cap_epochs 12 --t5_epochs 30 --warmup 4 \\
        --device cpu

Each stage runs as `python -m construction_clip_tpu_torch.apps.<app>` (or, with
--in_process, as that app's main() in this process), on --device: `cuda` (the
default; an error where no CUDA device works) or `cpu`, the training stages
in bf16 on the card and fp32 on the CPU (as predict's `--policy auto`). Pixels are synthesised per annotation with
class-structured patterns (synth_image: violation_type sets the stripes and
hue, caption_type the marker), written as JPEGs with PIL; the tokenizer files
are data/offline_assets.py's stand-ins. Stages 7-8 run on the host and need
the `tokenizers` package.

It writes <workdir>/summary.json and exits nonzero if a stage fails or a
training curve of the run (those of the stages in the summary) never drops 2%
below its start. --stages reruns some stages and keeps the other stages'
records of an earlier summary.json, as tools/run_product_e2e.py does.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
import zlib

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGE_ORDER = ["train_clip", "parse_corpus", "train_clipcap", "predict",
               "score", "visualize", "json_to_text", "train_tokenizer",
               "train_clipcap_t5", "predict_t5", "score_t5"]
# the training stages and the loss log each writes, relative to the workdir
CURVES = {"train_clip": ("clip_loss", "log_clip/clip_comb9.jsonl"),
          "train_clipcap": ("caption_loss", "log_cap/clipcap.jsonl"),
          "train_clipcap_t5": ("t5_loss", "log_t5/t5_prefix.jsonl")}


# ---------------------------------------------------------------- synthesis

def synth_image(ann, size=(240, 320)):
    """Deterministic class-structured RGB image for an annotation.

    violation_type -> base hue + horizontal stripe period; caption_type ->
    bright square (violation) vs disc (status) marker; per-file seed -> noise
    + marker position. Classes are visually separable so the contrastive
    objective and the zero-shot pseudo-labeling have learnable structure.
    """
    import numpy as np

    from construction_clip_tpu_torch.data.labels import VIOLATION_TYPES

    h, w = size
    vt = ann.violation_type if ann.violation_type in VIOLATION_TYPES else None
    vt_idx = VIOLATION_TYPES.index(vt) if vt else len(VIOLATION_TYPES)
    seed = zlib.crc32(ann.file_name.encode()) & 0xFFFFFFFF
    rng = np.random.default_rng(seed)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    period = 8 + 6 * vt_idx
    stripes = 0.5 + 0.5 * np.sin(2 * np.pi * yy / period)
    hue = vt_idx / 10.0
    base = np.stack([
        stripes * (0.3 + 0.7 * hue),
        stripes * (1.0 - hue) * 0.8,
        0.25 + 0.5 * (xx / w),
    ], axis=-1)

    cy, cx = int(rng.integers(40, h - 40)), int(rng.integers(40, w - 40))
    r = 24
    if ann.caption_type == "violation":
        base[cy - r:cy + r, cx - r:cx + r] = (0.95, 0.1, 0.1)
    else:
        mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        base[mask] = (0.1, 0.9, 0.2)

    noise = rng.normal(0, 0.06, base.shape)
    img = np.clip(base + noise, 0, 1)
    return (img * 255).astype(np.uint8)


def _round_robin_subset(anns, n: int, key=None):
    """First n annotations taken round-robin across violation_type classes, so
    a small subset still covers every class (PairGroupDataset needs >=
    combination_num distinct classes to form any group at all). An n past
    the corpus takes it all (the loop stops after the largest class, where
    tools/run_product_e2e.py's copy would not stop)."""
    key = key or (lambda a: a.violation_type)
    by_class: dict = {}
    for a in anns:
        by_class.setdefault(key(a), []).append(a)
    out = []
    i = 0
    longest = max((len(v) for v in by_class.values()), default=0)
    while len(out) < n and i < longest:
        for cls in list(by_class):
            if i < len(by_class[cls]) and len(out) < n:
                out.append(by_class[cls][i])
        i += 1
    return out


def prepare_corpus(corpus_json: str, workdir: str, subset: int | None):
    """Synthesise the images and write the full/train/test split JSONs (80/20
    by order, the reference's split). Returns (image root, {split: path})."""
    from PIL import Image

    from construction_clip_tpu_torch.data.schema import load_annotations

    anns = load_annotations(corpus_json)
    if subset:
        anns = _round_robin_subset(anns, subset)
    img_root = os.path.join(workdir, "images")
    for a in anns:
        path = os.path.join(img_root, a.file_name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path):
            Image.fromarray(synth_image(a)).save(path, quality=90)

    with open(corpus_json, encoding="utf-8") as f:
        raw = json.load(f)["annotations"]
    if subset:
        raw = _round_robin_subset(raw, subset, key=lambda a: a.get("violation_type", ""))
    cut = int(len(raw) * 0.8)
    paths = {}
    for name, part in (("full", raw), ("train", raw[:cut]), ("test", raw[cut:])):
        p = os.path.join(workdir, f"e2e_{name}.json")
        with open(p, "w", encoding="utf-8") as f:
            json.dump({"type": "captions", "annotations": part}, f, ensure_ascii=False)
        paths[name] = p
    print(f"corpus: {len(raw)} annotations ({cut} train / {len(raw) - cut} test), "
          f"images under {img_root}")
    return img_root, paths


def write_assets(corpus_json: str, assets: str, *, tiny: bool):
    """The CLIP BPE merges (6 merges for the tiny_bpe towers) and the BERT
    vocab (128 entries for tiny GPT-2), from data/offline_assets.py.
    Returns (merges path, vocab directory)."""
    from construction_clip_tpu_torch.data import offline_assets

    vocab_dir = os.path.join(assets, "bert_zh_vocab")
    os.makedirs(vocab_dir, exist_ok=True)
    merges = os.path.join(assets, "clip_bpe_offline.txt.gz")
    if not os.path.exists(merges):
        offline_assets.write_clip_merges(
            merges, n_merges=6 if tiny else offline_assets.N_MERGES)
        offline_assets.write_bert_vocab(
            os.path.join(vocab_dir, "vocab.txt"),
            offline_assets.corpus_characters([corpus_json]), size=128 if tiny else 21128)
    return merges, vocab_dir


# ---------------------------------------------------------------- stages

def run_stage(name: str, app: str, argv: list[str], log_path: str, *,
              in_process: bool) -> dict:
    """One stage: the port's apps/<app>.py with `argv`, its output in
    `log_path`; returns the stage record."""
    print(f"\n=== stage {name}: {app} {' '.join(argv)}", flush=True)
    t0 = time.time()
    with open(log_path, "w", encoding="utf-8") as log:
        if in_process:
            rc = 0
            with contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
                try:
                    importlib.import_module(f"construction_clip_tpu_torch.apps.{app}").main(argv)
                except Exception:   # a stage's failure is its record's rc
                    traceback.print_exc(file=log)
                    rc = 1
                except SystemExit as e:
                    rc = e.code if isinstance(e.code, int) else int(e.code is not None)
        else:
            env = dict(os.environ, PYTHONPATH=REPO)
            rc = subprocess.run(
                [sys.executable, "-u", "-m", f"construction_clip_tpu_torch.apps.{app}", *argv],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO).returncode
    dt = time.time() - t0
    with open(log_path, encoding="utf-8") as f:
        tail = "".join(f.readlines()[-8:])
    print(f"--- {name}: rc={rc} {dt:.0f}s\n{tail}", flush=True)
    return {"stage": name, "argv": [app, *argv], "rc": rc, "seconds": round(dt, 1),
            "log": log_path}


def read_losses(jsonl_path: str, key: str = "loss"):
    if not os.path.exists(jsonl_path):
        return []
    out = []
    with open(jsonl_path, encoding="utf-8") as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                out.append((rec["step"], rec[key]))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus", default="all.json", help="the annotation JSON")
    p.add_argument("--workdir", default="runs/e2e_torch")
    p.add_argument("--subset", type=int, default=None,
                   help="use only the first N annotations, round-robin over the classes")
    p.add_argument("--arch", default="vit_b_32")
    p.add_argument("--gpt_size", default="base", choices=["base", "tiny"])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error where no CUDA device works) or cpu")
    p.add_argument("--clip_epochs", type=int, default=8)
    p.add_argument("--clip_lr", type=float, default=1e-4)
    p.add_argument("--clip_groups_per_batch", type=int, default=1)
    p.add_argument("--cap_epochs", type=int, default=60)
    p.add_argument("--cap_lr", type=float, default=1e-4)
    p.add_argument("--cap_bs", type=int, default=32)
    p.add_argument("--warmup", type=int, default=50,
                   help="short-run warmup (the reference's 5000 assumes 50k-step runs)")
    p.add_argument("--beam", action="store_true", default=True)
    p.add_argument("--greedy", dest="beam", action="store_false")
    p.add_argument("--predict_bs", type=int, default=8)
    p.add_argument("--t5", action="store_true", default=True,
                   help="also chain the mT5 decoder workflow (stages 7-11)")
    p.add_argument("--no_t5", dest="t5", action="store_false")
    p.add_argument("--t5_size", default="small", choices=["small", "tiny"])
    p.add_argument("--t5_epochs", type=int, default=None, help="default: --cap_epochs")
    p.add_argument("--from_stage", type=int, default=1,
                   help="resume from stage N (artifacts of earlier stages must exist)")
    p.add_argument("--stages", default=None,
                   help="comma-separated stage names to (re)run; the other stages are "
                        "skipped and their records of an earlier summary.json kept")
    p.add_argument("--in_process", action="store_true",
                   help="run each app's main() in this process, not a subprocess")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch.apps.common import resolve_device

    resolve_device(args.device)   # no CUDA device is an error before any stage
    wd = os.path.abspath(args.workdir)
    logdir = os.path.join(wd, "logs")
    os.makedirs(logdir, exist_ok=True)

    merges, vocab_dir = write_assets(args.corpus, os.path.join(wd, "assets"),
                                     tiny=args.arch.startswith("tiny"))
    img_root, paths = prepare_corpus(args.corpus, wd, args.subset)

    models = os.path.join(wd, "models")
    emb_npz = os.path.join(wd, "embedding.npz")
    out_dir = os.path.join(wd, "output")
    clip_npz = os.path.join(models, "clip_latest.npz")
    cap_npz = os.path.join(models, "clipcap.npz")
    device = ["--device", args.device]
    precision = ["--precision", "bf16" if args.device.startswith("cuda") else "fp32"]

    if args.stages:
        selected = {s.strip() for s in args.stages.split(",")}
        unknown = selected - set(STAGE_ORDER)
        if unknown:
            sys.exit(f"unknown --stages {sorted(unknown)}; choose from {STAGE_ORDER}")
    else:
        selected = set(STAGE_ORDER[args.from_stage - 1:])
    stages = []
    summary_path = os.path.join(wd, "summary.json")
    if selected != set(STAGE_ORDER) and os.path.exists(summary_path):
        with open(summary_path, encoding="utf-8") as f:
            prior = json.load(f).get("stages", [])
        stages += [s for s in prior if s.get("stage") in set(STAGE_ORDER) - selected]

    def stage(name, app, argv):
        if name not in selected:
            print(f"=== stage {name}: skipped (its earlier record kept)")
            return
        res = run_stage(name, app, argv, os.path.join(logdir, f"{name}.log"),
                        in_process=args.in_process)
        stages.append(res)
        if res["rc"] != 0:
            summary(stages, wd, ok=False)
            sys.exit(f"stage {name} failed; see {res['log']}")

    stage("train_clip", "train_clip", [
        "--json_path", paths["full"], "--image_path", img_root,
        "--arch", args.arch, "--clip_bpe", merges,
        "--epochs", str(args.clip_epochs), "--save_every", str(args.clip_epochs),
        "--lr", str(args.clip_lr), "--warmup_steps", str(args.warmup),
        "--groups_per_batch", str(args.clip_groups_per_batch),
        "--output_dir", models, "--output_prefix", "clip",
        "--log_dir", os.path.join(wd, "log_clip"), *precision, *device])

    stage("parse_corpus", "parse_corpus", [
        "--json_path", paths["train"], "--image_root", img_root,
        "--checkpoint", clip_npz, "--clip_bpe", merges,
        *(["--arch", args.arch] if args.arch != "vit_b_32" else []),
        "--out", emb_npz, *device])

    stage("train_clipcap", "train_clipcap", [
        "--data", emb_npz, "--out_dir", models, "--prefix", "clipcap",
        "--epochs", str(args.cap_epochs), "--save_every", str(args.cap_epochs),
        "--bs", str(args.cap_bs), "--lr", str(args.cap_lr),
        "--warmup_steps", str(args.warmup), "--gpt_size", args.gpt_size,
        "--tokenizer", vocab_dir, "--log_dir", os.path.join(wd, "log_cap"),
        *precision, *device])

    stage("predict", "predict", [
        "--json_path", paths["test"], "--image_root", img_root,
        "--clip_checkpoint", clip_npz, "--arch", args.arch,
        "--caption_checkpoint", cap_npz, "--clip_bpe", merges,
        "--tokenizer", vocab_dir, *([] if args.beam else ["--greedy"]),
        "--batch_size", str(args.predict_bs), "--output_dir", out_dir, *device])

    stage("score", "score", [os.path.join(out_dir, "output_log.json")])

    logs = {name: os.path.join(wd, rel) for name, (_, rel) in CURVES.items()}
    stage("visualize", "visualize", [
        *[logs[n] for n in ("train_clip", "train_clipcap") if os.path.exists(logs[n])],
        "--keys", "loss", "--out", os.path.join(wd, "curves.png")])

    if args.t5:
        text_txt = os.path.join(wd, "text.txt")
        bpe_json = os.path.join(wd, "assets", "chinese_bpe.json")
        t5_npz = os.path.join(models, "t5_prefix.npz")
        t5_epochs = str(args.t5_epochs or args.cap_epochs)

        stage("json_to_text", "json_to_text", [
            "--json_path", paths["train"], "--out", text_txt, "--key", "caption"])

        stage("train_tokenizer", "train_tokenizer", ["--input", text_txt, "--out", bpe_json])

        stage("train_clipcap_t5", "train_clipcap_t5", [
            "--data", emb_npz, "--out_dir", models, "--prefix", "t5_prefix",
            "--epochs", t5_epochs, "--save_every", t5_epochs,
            "--bs", str(args.cap_bs), "--lr", str(args.cap_lr),
            "--warmup_steps", str(args.warmup), "--t5_size", args.t5_size,
            "--tokenizer", bpe_json, "--log_dir", os.path.join(wd, "log_t5"),
            *precision, *device])

        stage("predict_t5", "predict_t5", [
            "--json_path", paths["test"], "--image_root", img_root,
            "--clip_checkpoint", clip_npz, "--arch", args.arch,
            "--clip_bpe", merges, "--caption_checkpoint", t5_npz,
            "--tokenizer", bpe_json, "--t5_size", args.t5_size, "--greedy",
            "--batch_size", str(args.predict_bs),
            "--out", os.path.join(out_dir, "output_t5.json"), *device])

        stage("score_t5", "score", [os.path.join(out_dir, "output_t5.json")])

    summary(stages, wd, ok=True, logs=logs, out_dir=out_dir)


def _read_score_json(stages, stage_name):
    logs = [s for s in stages if s["stage"] == stage_name]
    if not logs:
        return None
    try:
        with open(logs[0]["log"], encoding="utf-8") as f:
            txt = f.read()
        return json.loads(txt[txt.index("{"):])
    except (OSError, ValueError, KeyError):
        return None


def _read_preds(out_dir, fname):
    path = os.path.join(out_dir or "", fname)
    if not (out_dir and os.path.exists(path)):
        return None, None
    with open(path, encoding="utf-8") as f:
        preds = json.load(f)
    return len(preds), len({p["caption"] for p in preds})


def summary(stages, wd, *, ok, logs=None, out_dir=None):
    """Write <wd>/summary.json: the stage records and, for a run that ended,
    each training curve in the records (first, last, min), the scores and
    the prediction counts. `losses_decreased` holds when every such curve
    drops 2% below its start; a run whose curves did not exits nonzero."""
    stages = sorted(stages, key=lambda s: STAGE_ORDER.index(s["stage"])
                    if s.get("stage") in STAGE_ORDER else 99)
    out = {"ok": ok, "stages": stages}
    if ok:
        def curve(pts):
            if not pts:
                return None
            return {"first": pts[0], "last": pts[-1],
                    "min": min(p[1] for p in pts), "n": len(pts)}

        ran = {s["stage"] for s in stages}
        curves = []
        for name, (key, _) in CURVES.items():
            if name in ran:
                out[key] = curve(read_losses(logs[name]))
                curves.append(out[key])
        if ran & {"predict", "score"}:
            n_preds, uniq = _read_preds(out_dir, "output_log.json")
            out.update({"score": _read_score_json(stages, "score"),
                        "n_predictions": n_preds, "unique_captions": uniq})
        if ran & {"predict_t5", "score_t5"}:
            n_t5, uniq_t5 = _read_preds(out_dir, "output_t5.json")
            out.update({"t5_score": _read_score_json(stages, "score_t5"),
                        "t5_n_predictions": n_t5, "t5_unique_captions": uniq_t5})
        # a missing curve is a failure, as is one that never drops 2% below its start
        out["losses_decreased"] = bool(curves) and all(
            c is not None and c["min"] < c["first"][1] * 0.98 for c in curves)
    path = os.path.join(wd, "summary.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False, indent=2)
    print(f"\nsummary -> {path}")
    print(json.dumps({k: v for k, v in out.items() if k != "stages"},
                     ensure_ascii=False, indent=2))
    if ok and not out.get("losses_decreased", False):
        sys.exit("losses did not decrease — see summary.json")


if __name__ == "__main__":
    main()
