"""Zero-shot classification of a corpus, with an optional similarity-matrix
plot (the port's counterpart of apps/predict_zeroshot.py):

    python -m construction_clip_tpu_torch.apps.predict_zeroshot --json_path test.json \\
        --image_root images/ --checkpoint clip_latest.npz --out predictions.json

The flags, defaults and output JSON are apps/predict_zeroshot.py's. --checkpoint
takes the .npz that either package writes or a .pt state dict (OpenAI's or
HF's, apps/common.load_clip); without one, the weights are random
from a fixed seed. It runs on --device: `cuda` (the default; an error where no
CUDA device works) or `cpu`, in fp32 weights and compute on both, as the JAX
app (it passes no precision policy). Images are read with PIL and
staged at 256x256 on the host; on a machine without PIL, drive `make_process`
with uint8 arrays.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from construction_clip_tpu_torch.apps.common import (
    add_device_flag, load_clip, load_clip_tokenizer, resolve_device, stream_corpus)
from construction_clip_tpu_torch.core.configs import CLIPConfig
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.data.labels import (
    CAPTION_TYPE_PROMPTS, CAPTION_TYPES, VIOLATION_TYPES)
from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.infer.zeroshot import classify_batch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../test.json")
    p.add_argument("--image_root", default="../")
    p.add_argument("--key", default="violation_type",
                   choices=["violation_type", "caption_type"])
    p.add_argument("--checkpoint", default=None,
                   help=".npz params (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--plot", default=None, help="write similarity-matrix figure here")
    p.add_argument("--out", default=None, help="write predictions JSON here")
    add_device_flag(p)
    return p.parse_args(argv)


def make_process(params, cfg: CLIPConfig, feats, names, key: str, device, *,
                 policy: Policy = DEFAULT_POLICY):
    """The app's batch function: process(batch_anns, staged_u8 [n, S, S, 3]) ->
    (result records, probs [n, L]). `feats` are the labels' features
    (infer/zeroshot.label_features), `names` their names."""

    def process(batch_anns, staged):
        images = preprocess_batch(staged, cfg.vision.image_size, device=device)
        probs, pred = classify_batch(params, cfg, images, feats, policy=policy)
        records = []
        for a, pr, pd in zip(batch_anns, probs.cpu().numpy(), pred.tolist()):
            records.append({"id": a.id, "file_name": a.file_name, "prediction": names[pd],
                            "ground_truth": getattr(a, key), "probs": pr.round(4).tolist()})
        return records, probs

    return process


def plot_similarity(path: str, probs: np.ndarray, names) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(max(6, len(names)), max(4, len(probs) / 4)))
    ax.imshow(probs, vmin=0, vmax=1, cmap="viridis")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45)
    ax.set_ylabel("image")
    fig.colorbar(ax.images[0])
    fig.tight_layout()
    fig.savefig(path, dpi=120)


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.infer.zeroshot import label_features

    device = resolve_device(args.device)
    policy = DEFAULT_POLICY
    tree, cfg = load_clip(args.checkpoint, arch=args.arch)
    params = convert.to_params(tree, dtype=policy.compute_dtype, device=device).tree()
    tokenizer = load_clip_tokenizer(
        args.clip_bpe, expect_vocab=cfg.text.vocab_size if args.checkpoint else None)
    if args.key == "violation_type":
        prompts, names = list(VIOLATION_TYPES), list(VIOLATION_TYPES)
    else:
        prompts, names = list(CAPTION_TYPE_PROMPTS), list(CAPTION_TYPES)
    feats = label_features(params, cfg, tokenizer.tokenize(prompts, cfg.text.context_length),
                           policy=policy)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}), compute dtype {policy.compute_dtype}")
    process = make_process(params, cfg, feats, names, args.key, device, policy=policy)

    results, all_probs = [], []
    for batch_anns, staged in stream_corpus(load_annotations(args.json_path), args.image_root,
                                            args.batch_size):
        records, probs = process(batch_anns, staged)
        results.extend(records)
        all_probs.append(probs.cpu().numpy())
    scored = [r for r in results if r["ground_truth"]]
    if scored:
        correct = sum(r["prediction"] == r["ground_truth"] for r in scored)
        print(f"accuracy: {correct}/{len(scored)} = {correct / len(scored):.3f}")
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=2)
        print(f"wrote {args.out}")
    if args.plot and all_probs:
        plot_similarity(args.plot, np.concatenate(all_probs), names)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
