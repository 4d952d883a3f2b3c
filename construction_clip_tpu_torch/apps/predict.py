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
fp32 on the CPU, as the JAX app's auto is bf16 on the TPU. --mapping_type
transformer builds the transformer mapper as the JAX app does (8 layers over
10 projected rows), so it reads a train_clipcap checkpoint trained with
--prefix_length_clip 10.

Rows the caption pipeline flags `decode_suspect` are captioned again after
--suspect_backoff seconds, up to --suspect_retries times, as in the JAX app.
--explain writes, for each image, `<name>.relevance.png` (the CLS row's
relevance over the image, a JET overlay) and `<name>.relevance.html` (the
caption's per-character relevance), from infer/explain.interpret on the fp32
CLIP params whatever --policy is; --attention_maps writes `<name>.attn.png`,
the decoder's last-layer attention over the prompt and the caption, from the
fp32 GPT-2 params (the prompt itself under --policy), as the JAX app. The
per-image work is `make_explain`, which returns arrays; `main` writes the
files. Images are read with PIL; on a machine without PIL, call
`make_process` and `make_explain` with uint8 arrays.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
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
    p.add_argument("--suspect_retries", type=int, default=2,
                   help="re-run rows still decode_suspect after the pipeline's greedy "
                        "retry this many times")
    p.add_argument("--suspect_backoff", type=float, default=300.0,
                   help="seconds to wait before each decode_suspect re-run")
    p.add_argument("--plots", action="store_true", help="write annotated figures")
    p.add_argument("--explain", action="store_true", help="relevance overlays")
    p.add_argument("--attention_maps", action="store_true",
                   help="per-token decoder attention heatmaps")
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

    process.pipe = pipe
    return process


def make_explain(pipe: CaptionPipeline, clip_params, gpt_params, *, explain: bool = True,
                 attention_maps: bool = True, device):
    """The per-image explainability of `pipe`'s captions: explain(staged_u8 [n,
    S, S, 3], records) -> one dict an image: "overlay" (uint8 [S, S, 3], the
    relevance over the image) and "char_scores" ([(char, score)]) with
    `explain`; "attention" ([n_tokens, seq_len] fp32 rows) and "labels" (the
    caption's tokens) with `attention_maps`, None where the caption has no
    token. clip_params and gpt_params are the fp32 trees on `device`: relevance
    and attention run in fp32 whatever the pipeline's policy (the JAX app's
    interpret and decoder_attention_map take its DEFAULT_POLICY), the prompt
    under the pipeline's."""
    from construction_clip_tpu_torch.infer import explain as ex

    cfg = pipe.clip_cfg

    def run(staged, records):
        if staged.shape[1] != staged.shape[2]:
            raise ValueError(f"staged images must be square, got {staged.shape[1:3]}")
        images = preprocess_batch(staged, cfg.vision.image_size, device=device)
        out = []
        for i, rec in enumerate(records):
            text = rec["caption"] or rec["attribute"]
            item = {}
            if explain:
                tokens = pipe.clip_tokenizer.tokenize([text], cfg.text.context_length)
                r_text, r_image = ex.interpret(clip_params, cfg, images[i:i + 1], tokens)
                heat = ex.image_relevance_map(r_image[0, 0], cfg.vision.grid,
                                              out_size=staged.shape[1])
                # the JAX app's round trip through an 8-bit image (its resize to
                # the staged size is the identity: heat is made at that size)
                heat = (heat * 255).astype(np.uint8) / 255.0
                item.update(overlay=ex.overlay_heatmap(staged[i], heat),
                            char_scores=ex.text_heatmap_per_char(
                                r_text[0], tokens[0], text, pipe.clip_tokenizer))
            if attention_maps:
                ids = pipe.lm_tokenizer.encode(text)
                rows = None
                if ids:
                    with torch.inference_mode():
                        emb, _ = pipe.classify_and_embed(images[i:i + 1])
                        prompt = pipe.prompt_embeds(
                            emb, pipe.attribute_tokens([rec["attribute"]]))
                    rows = ex.decoder_attention_map(
                        gpt_params, pipe.gcfg, prompt,
                        torch.as_tensor(np.asarray(ids, np.int32)[None], device=device))
                item.update(attention=rows,
                            labels=[pipe.lm_tokenizer.decode([t]) for t in ids] if ids
                            else None)
            out.append(item)
        return out

    return run


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    device = resolve_device(args.device)
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
    explain = None
    if args.explain or args.attention_maps:
        explain = make_explain(process.pipe, convert.to_params(clip_tree, device=device),
                               convert.to_params(cap_tree["gpt"], device=device),
                               explain=args.explain, attention_maps=args.attention_maps,
                               device=device)

    os.makedirs(args.output_dir, exist_ok=True)
    annotations = load_annotations(args.json_path)
    results = []
    for batch_anns, staged in stream_corpus(annotations, args.image_root, args.batch_size):
        records = process(batch_anns, staged)
        results.extend(records)
        items = explain(staged, records) if explain is not None else [None] * len(records)
        for rec, item in zip(records, items):
            base = os.path.join(args.output_dir, os.path.basename(rec["file_name"]))
            if args.plots:
                _plot(os.path.join(args.image_root, rec["file_name"]), rec, base + ".png")
            if args.explain:
                _write_relevance(item, rec, base + ".relevance.png")
            if args.attention_maps and item["attention"] is not None:
                from construction_clip_tpu_torch.infer.explain import plot_attention_map

                plot_attention_map(item["attention"], base + ".attn.png",
                                   token_labels=item["labels"])

    # rows the pipeline flagged decode_suspect (still empty at max_steps after
    # its greedy retry) are captioned again after a backoff, as the JAX app
    # does; their plots and explain files are not made again
    by_id = {a.id: a for a in annotations}
    for attempt in range(args.suspect_retries):
        sus = [r for r in results if r["decode_suspect"]]
        if not sus:
            break
        print(f"decode_suspect rows: {len(sus)}/{len(results)} — retry "
              f"{attempt + 1}/{args.suspect_retries} after {args.suspect_backoff:.0f}s "
              f"backoff", flush=True)
        time.sleep(args.suspect_backoff)
        rec_by_id = {r["id"]: r for r in sus}
        for batch_anns, staged in stream_corpus([by_id[r["id"]] for r in sus],
                                                args.image_root, args.batch_size):
            images = preprocess_batch(staged, clip_cfg.vision.image_size, device=device)
            for a, pr in zip(batch_anns, process.pipe.caption_images(images,
                                                                     use_beam=args.beam)):
                rec_by_id[a.id].update(pr)
    n_sus = sum(1 for r in results if r["decode_suspect"])
    if n_sus:
        print(f"WARNING: {n_sus}/{len(results)} rows remain decode_suspect after "
              f"{args.suspect_retries} retries", flush=True)
    out_json = os.path.join(args.output_dir, "output_log.json")
    with open(out_json, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    print(f"wrote {out_json} ({len(results)} items)")


def _write_relevance(item, rec, out_path):
    """The relevance overlay PNG and, beside it, the caption's per-character
    heatmap HTML."""
    from PIL import Image

    from construction_clip_tpu_torch.infer.explain import render_text_heatmap_html

    Image.fromarray(item["overlay"]).save(out_path)
    render_text_heatmap_html(item["char_scores"], out_path.rsplit(".", 1)[0] + ".html",
                             title=rec["caption"] or rec["attribute"])


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
