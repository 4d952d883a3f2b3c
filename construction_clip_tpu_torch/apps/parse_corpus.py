"""CLIP-embedding precompute + attribute pseudo-labeling of a corpus (the
port's counterpart of apps/parse_corpus.py, the CLIP_prefix_caption/
parse_coco.py entry point):

    python -m construction_clip_tpu_torch.apps.parse_corpus --json_path all.json \\
        --image_root images/ --checkpoint clip_latest.npz --out embedding.npz

The flags and defaults are apps/parse_corpus.py's, and it writes the same .npz
keys (embeddings, attributes, captions) for the ClipCap training. --checkpoint
takes the .npz that either package writes or a .pt state dict (OpenAI's or
HF's, apps/common.load_clip); without one, the weights are random
from a fixed seed. It runs on --device: `cuda` (the default; an error where no
CUDA device works) or `cpu`, in fp32 weights and compute on both, as the JAX
app (it passes no precision policy). Images are read with PIL; on a
machine without PIL, call infer/precompute.precompute_corpus with a
`load_image` of its own.
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import (
    add_device_flag, load_clip, load_clip_tokenizer, resolve_device)

ARCHES = {"ViT-B/32": "vit_b_32", "ViT-B/16": "vit_b_16", "ViT-L/14": "vit_l_14"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--clip_model_type", default="ViT-B/32", choices=list(ARCHES))
    p.add_argument("--json_path", default="../all.json")
    p.add_argument("--image_root", default="../")
    p.add_argument("--checkpoint", default=None,
                   help="CLIP weights: .npz (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--out", default="./embedding/ViT-B_32_train_embedding.npz")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--arch", default=None,
                   help="override the clip_model_type arch mapping (e.g. tiny_bpe "
                        "for test-scale runs)")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.precision import DEFAULT_POLICY
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.infer.precompute import precompute_corpus

    device = resolve_device(args.device)
    policy = DEFAULT_POLICY
    tree, cfg = load_clip(args.checkpoint, arch=args.arch or ARCHES[args.clip_model_type])
    params = convert.to_params(tree, dtype=policy.compute_dtype, device=device).tree()
    tokenizer = load_clip_tokenizer(
        args.clip_bpe, expect_vocab=cfg.text.vocab_size if args.checkpoint else None)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    out = precompute_corpus(params, cfg, load_annotations(args.json_path), tokenizer,
                            image_root=args.image_root, batch_size=args.batch_size,
                            policy=policy, out_path=args.out)
    print(f"wrote {args.out}: {len(out['embeddings'])} embeddings")


if __name__ == "__main__":
    main()
