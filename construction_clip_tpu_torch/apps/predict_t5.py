"""ClipCap mT5 caption inference on one device (the port's counterpart of
apps/predict_t5.py): uint8 image -> CLIP embedding and zero-shot classes ->
attribute string -> mT5 encoder states, with the mapped CLIP prefix in front ->
cached sampled (or --greedy) T5 decode -> caption.

    python -m construction_clip_tpu_torch.apps.predict_t5 --json_path test.json \\
        --image_root images/ --tokenizer bpe.json --caption_checkpoint t5cap.npz

The flags, defaults and output JSON are apps/predict_t5.py's. CLIP and caption
checkpoints are the .npz files that either package writes (CLIP also a .pt
state dict, OpenAI's or HF's, as apps/common.load_clip reads it); without one, the
weights are random from a fixed seed. The tokenizer is a `tokenizers` JSON
file. It runs on --device: `cuda` (the default; an error where no CUDA device
works) or `cpu`, in fp32 weights and compute on both, as the JAX app (it
passes no precision policy).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from construction_clip_tpu_torch import convert
from construction_clip_tpu_torch.apps.common import (
    TokenizerFile, add_device_flag, fit_t5_vocab, load_clip, load_clip_tokenizer,
    resolve_device, stream_corpus)
from construction_clip_tpu_torch.core.configs import CLIPConfig, ClipCapConfig, T5Config
from construction_clip_tpu_torch.core.params import as_tree
from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY, Policy
from construction_clip_tpu_torch.data.labels import (
    CAPTION_TYPE_PROMPTS, VIOLATION_TYPES, attribute_string)
from construction_clip_tpu_torch.data.preprocess import preprocess_batch
from construction_clip_tpu_torch.infer.decode_t5 import t5_generate
from construction_clip_tpu_torch.infer.precompute import make_embed_classify_fn
from construction_clip_tpu_torch.models.clipcap.t5_model import encode_with_prefix

ATTRIBUTE_IDS = 8      # attribute tokens fed to the encoder, zero-padded
SAMPLE_SEED = 567      # every batch samples from this seed, as the JAX app's key


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../test.json")
    p.add_argument("--image_root", default="../")
    p.add_argument("--clip_checkpoint", default=None,
                   help=".npz params (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--caption_checkpoint", default=None, help="npz {mapper,t5}")
    p.add_argument("--tokenizer", default="chinese_bpe.json", help="a tokenizers JSON file")
    p.add_argument("--prefix_length", type=int, default=20)
    p.add_argument("--mapping_type", default="mlp")
    p.add_argument("--t5_size", default="small", choices=["small", "tiny"])
    p.add_argument("--max_length", type=int, default=32)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--out", default="output/output_t5.json")
    add_device_flag(p)
    return p.parse_args(argv)


def attribute_ids(lm_tok, attrs) -> np.ndarray:
    ids = np.zeros((len(attrs), ATTRIBUTE_IDS), np.int32)
    for i, a in enumerate(attrs):
        e = lm_tok.encode(a)[:ATTRIBUTE_IDS]
        ids[i, :len(e)] = e
    return ids


def make_process(clip_params, clip_cfg: CLIPConfig, cap_params, ccfg: ClipCapConfig,
                 tcfg: T5Config, clip_tok, lm_tok, *, max_length: int = 32,
                 greedy: bool = False, policy: Policy, device):
    """The app's batch function: process(batch_anns, staged_u8 [n, S, S, 3]) ->
    (result records, DecodeResult). Params are trees on `device`."""
    clip_params, cap_params = as_tree(clip_params), as_tree(cap_params)
    ctx = clip_cfg.text.context_length
    embed_classify = make_embed_classify_fn(
        clip_params, clip_cfg, clip_tok.tokenize(list(CAPTION_TYPE_PROMPTS), ctx),
        clip_tok.tokenize(list(VIOLATION_TYPES), ctx), policy=policy)

    @torch.inference_mode()
    def process(batch_anns, staged):
        x = preprocess_batch(staged, clip_cfg.vision.image_size, device=device)
        emb, ct, vt = embed_classify(x)
        attrs = [attribute_string(CAPTION_TYPE_PROMPTS[c], VIOLATION_TYPES[v])
                 for c, v in zip(ct.tolist(), vt.tolist())]
        ids = torch.from_numpy(attribute_ids(lm_tok, attrs)).to(device)
        hidden, mask = encode_with_prefix(
            cap_params, ccfg, tcfg, input_ids=ids, attention_mask=(ids != 0).int(),
            clip_embed=emb, policy=policy)
        res = t5_generate(cap_params["t5"], tcfg, hidden,
                          generator=torch.Generator(device=device).manual_seed(SAMPLE_SEED),
                          encoder_mask=mask, max_steps=max_length, do_sample=not greedy,
                          policy=policy)
        records = []
        for ann, attr, row, n in zip(batch_anns, attrs, res.tokens.tolist(),
                                     res.lengths.tolist()):
            cap = lm_tok.decode([t for t in row[:n] if t > 1],
                                skip_special_tokens=True).replace(" ", "")
            records.append({"id": ann.id, "file_name": ann.file_name, "attribute": attr,
                            "caption": cap,
                            "ground_truth_caption": ann.caption or ann.violation_list})
            print(f"{ann.file_name}: {attr}{cap}")
        return records, res

    return process


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    device = resolve_device(args.device)
    policy = DEFAULT_POLICY
    clip_tree, clip_cfg = load_clip(args.clip_checkpoint, arch=args.arch)
    clip_tok = load_clip_tokenizer(
        args.clip_bpe, expect_vocab=clip_cfg.text.vocab_size if args.clip_checkpoint else None)
    lm_tok = TokenizerFile(args.tokenizer)
    tcfg = fit_t5_vocab(T5Config() if args.t5_size == "small" else T5Config.tiny(), lm_tok)
    ccfg = ClipCapConfig(prefix_length=args.prefix_length, attribute_length=0,
                         clip_dim=clip_cfg.text.embed_dim, mapper=args.mapping_type)
    cap_tree = (load_params_npz(args.caption_checkpoint,
                                convert.init_clipcap_t5(convert.SHAPES, ccfg, tcfg))
                if args.caption_checkpoint else convert.init_clipcap_t5(0, ccfg, tcfg))
    clip_params = convert.to_params(clip_tree, dtype=policy.compute_dtype, device=device)
    cap_params = convert.to_params(cap_tree, dtype=policy.compute_dtype, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name}), compute dtype {policy.compute_dtype}")
    process = make_process(clip_params, clip_cfg, cap_params, ccfg, tcfg, clip_tok, lm_tok,
                           max_length=args.max_length, greedy=args.greedy, policy=policy,
                           device=device)

    results = []
    for batch_anns, staged in stream_corpus(load_annotations(args.json_path), args.image_root,
                                            args.batch_size):
        results.extend(process(batch_anns, staged)[0])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(results, f, ensure_ascii=False, indent=2)
    print(f"wrote {args.out} ({len(results)} items)")


if __name__ == "__main__":
    main()
