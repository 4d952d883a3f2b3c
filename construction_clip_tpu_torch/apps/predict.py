"""Batch captioning (the port's counterpart of apps/predict.py, the root
predict.py / test.py:predict() entry point): a corpus streamed through
preprocessing, zero-shot classification and ClipCap beam-3 (or --greedy)
captioning in batches, written to `<output_dir>/output_log.json`.

    python -m construction_clip_tpu_torch.apps.predict --json_path test.json \\
        --image_root images/ --clip_checkpoint clip_latest.npz \\
        --caption_checkpoint models/clipcap.npz --tokenizer vocab.txt

The flags and the records are apps/predict.py's, with these differences.
CLIP and caption checkpoints are the .npz files that either package writes
(CLIP also a .pt state dict, OpenAI's or HF's, as apps/common.load_clip reads
it); without one, the weights are the port's random init from a fixed seed.
--tokenizer is a local BERT vocab.txt (or a directory holding one), `vocab.txt`
by default. It runs on --device: `cuda` (the default; an error where no CUDA
device works) or `cpu`; --policy auto computes in bf16 on the card and in
fp32 on the CPU, as the JAX app's auto is bf16 on the TPU. Rows the caption
pipeline flags `decode_suspect` keep the flag in their record and are not
re-run: the JAX app's re-run of such rows after a backoff (a TPU fault's
remedy) is not ported (ROADMAP.md Queue 1 item 7), so --suspect_retries
defaults to 0 here and a re-run (--suspect_retries above 0, or a
--suspect_backoff) raises. --explain and --attention_maps are not ported
(ROADMAP.md Queue 1 item 5) and raise. Images are read with PIL; on a machine without PIL, call
`make_process` with uint8 arrays.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from construction_clip_tpu_torch.apps.common import (
    TokenizerFile, add_device_flag, load_clip, load_clip_tokenizer, resolve_device,
    stream_corpus)
from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, GPT2Config
from construction_clip_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.infer.caption import CaptionPipeline


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="test.json")
    p.add_argument("--image_root", default=".")
    p.add_argument("--clip_checkpoint", default=None,
                   help=".npz params (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--caption_checkpoint", default=None,
                   help="npz of clipcap params {mapper,gpt} (train_clipcap output)")
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--tokenizer", default="vocab.txt",
                   help="BERT vocab.txt, a directory holding one, or a tokenizers JSON")
    p.add_argument("--prefix_length", type=int, default=20)
    p.add_argument("--attribute_length", type=int, default=20)
    p.add_argument("--mapping_type", default="mlp")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--policy", default="auto", choices=["auto", "fp32", "bf16"],
                   help="compute precision; auto = bf16 on cuda, fp32 on cpu")
    p.add_argument("--beam", action="store_true", default=True)
    p.add_argument("--greedy", dest="beam", action="store_false")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--suspect_retries", type=int, default=0,
                   help="only 0: re-running decode_suspect rows is not ported")
    p.add_argument("--suspect_backoff", type=float, default=None,
                   help="not ported (the wait before a decode_suspect re-run)")
    p.add_argument("--plots", action="store_true", help="write annotated figures")
    p.add_argument("--explain", action="store_true", help="not ported")
    p.add_argument("--attention_maps", action="store_true", help="not ported")
    add_device_flag(p)
    return p.parse_args(argv)


def resolve_policy(name: str, device: torch.device) -> Policy:
    """--policy: auto is bf16 on a CUDA device and fp32 on the CPU."""
    if name == "auto":
        return BF16_POLICY if device.type == "cuda" else DEFAULT_POLICY
    return {"fp32": DEFAULT_POLICY, "bf16": BF16_POLICY}[name]


def make_process(clip_params, clip_cfg: CLIPConfig, cap_params, ccfg: ClipCapConfig,
                 gcfg: GPT2Config, clip_tok, lm_tok, *, use_beam: bool = True,
                 policy: Policy, device):
    """The app's batch function: process(batch_anns, staged_u8 [n, S, S, 3]) ->
    the batch's output_log.json records. Params are trees on `device`."""
    pipe = CaptionPipeline(clip_params=clip_params, clip_cfg=clip_cfg, cap_params=cap_params,
                           ccfg=ccfg, gcfg=gcfg, clip_tokenizer=clip_tok,
                           lm_tokenizer=lm_tok, policy=policy)

    def process(batch_anns, staged):
        images = preprocess_batch(staged, clip_cfg.vision.image_size, device=device)
        records = []
        for a, pr in zip(batch_anns, pipe.caption_images(images, use_beam=use_beam)):
            records.append({"id": a.id, "file_name": a.file_name,
                            "ground_truth_caption": a.caption or a.violation_list,
                            "ground_truth_attribute": f"{a.caption_type} {a.violation_type} ",
                            **pr})
            print(f"{a.file_name}: {pr['attribute']}{pr['caption']}")
        return records

    return process


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    device = resolve_device(args.device)
    if args.explain or args.attention_maps:
        raise NotImplementedError("--explain and --attention_maps are not ported yet "
                                  "(ROADMAP.md Queue 1 item 5)")
    if args.suspect_retries or args.suspect_backoff is not None:
        raise NotImplementedError("re-running decode_suspect rows (--suspect_retries, "
                                  "--suspect_backoff) is not ported (ROADMAP.md Queue 1 "
                                  "item 7)")
    policy = resolve_policy(args.policy, device)
    clip_tree, clip_cfg = load_clip(args.clip_checkpoint, arch=args.arch)
    gcfg = GPT2Config.tiny() if args.arch.startswith("tiny") else GPT2Config()
    ccfg = ClipCapConfig(prefix_length=args.prefix_length,
                         attribute_length=args.attribute_length, mapper=args.mapping_type,
                         clip_dim=clip_cfg.text.embed_dim)
    cap_tree = (load_params_npz(args.caption_checkpoint,
                                convert.init_clipcap(convert.SHAPES, ccfg, gcfg))
                if args.caption_checkpoint else convert.init_clipcap(0, ccfg, gcfg))
    clip_tok = load_clip_tokenizer(
        args.clip_bpe, expect_vocab=clip_cfg.text.vocab_size if args.clip_checkpoint else None)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}), compute dtype {policy.compute_dtype}")
    process = make_process(
        convert.to_params(clip_tree, dtype=policy.compute_dtype, device=device), clip_cfg,
        convert.to_params(cap_tree, dtype=policy.compute_dtype, device=device), ccfg, gcfg,
        clip_tok, TokenizerFile(args.tokenizer), use_beam=args.beam, policy=policy,
        device=device)

    os.makedirs(args.output_dir, exist_ok=True)
    results = []
    for batch_anns, staged in stream_corpus(load_annotations(args.json_path), args.image_root,
                                            args.batch_size):
        records = process(batch_anns, staged)
        results.extend(records)
        if args.plots:
            for rec in records:
                base = os.path.basename(rec["file_name"])
                _plot(os.path.join(args.image_root, rec["file_name"]), rec,
                      os.path.join(args.output_dir, base + ".png"))
    n_sus = sum(1 for r in results if r["decode_suspect"])
    if n_sus:
        print(f"WARNING: {n_sus}/{len(results)} rows are decode_suspect (flagged in "
              f"their records; not re-run)", flush=True)
    out_json = os.path.join(args.output_dir, "output_log.json")
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    print(f"wrote {out_json} ({len(results)} items)")


def _plot(image_path, rec, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    fig, ax = plt.subplots()
    with Image.open(image_path) as im:
        ax.imshow(im)
    ax.axis("off")
    ax.set_title(f"pred: {rec['attribute']}{rec['caption']}\n"
                 f"gt: {rec['ground_truth_attribute']}{rec['ground_truth_caption']}")
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)


if __name__ == "__main__":
    main()
