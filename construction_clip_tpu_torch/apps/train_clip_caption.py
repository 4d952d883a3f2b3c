"""Contrastive CLIP fine-tune on plain (image, caption) pairs (the port's
counterpart of apps/train_clip_caption.py, the CLIP/train_caption.py entry
point), on one device or data-parallel:

    python -m construction_clip_tpu_torch.apps.train_clip_caption --json_path all.json \\
        --image_path images/ --arch vit_b_32
    torchrun --nproc_per_node 4 -m construction_clip_tpu_torch.apps.train_clip_caption \\
        --json_path all.json --image_path images/

Same flags and defaults as apps/train_clip_caption.py (--key violation_list,
--batch_size 8 a device, --output_prefix clip_cap, the symmetric InfoNCE,
AdamW at 1e-5 with 5000 warmup steps), except that --resume names a
checkpoint directory of this package, --checkpoint takes the .npz that
either package writes or a .pt state dict. --native_loader decodes JPEGs
with the port's C++ libjpeg ingest (data/native_loader.py). The training
loop is apps/train_clip.py's (`fit`): it trains on
--device (`cuda`, the default, or `cpu`), makes every epoch a resumable
unit under `<output_dir>/<output_prefix>/`, and writes
`<output_prefix>_latest.npz` at the end. Under `torchrun` each rank takes
--batch_size rows of every global batch of --batch_size x world pairs, and
the loss is the global batch's InfoNCE (the features all-gathered by K10).
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import add_device_flag
from construction_clip_tpu_torch.apps.train_clip import fit, join_world


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../all.json")
    p.add_argument("--image_path", default="../")
    p.add_argument("--key", default="violation_list")
    p.add_argument("--train_ratio", type=float, default=0.8)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=8, help="per-device")
    p.add_argument("--checkpoint", default=None,
                   help=".npz params (either package's) or a .pt state dict (OpenAI or HF)")
    p.add_argument("--clip_bpe", default=None)
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--output_dir", default="models")
    p.add_argument("--output_prefix", default="clip_cap")
    p.add_argument("--resume", default=None, help="checkpoint dir of this package")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--native_loader", action="store_true",
                   help="decode JPEGs with the C++ libjpeg ingest "
                        "(construction_clip_tpu_torch/native/)")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return train(args)
    dp = join_world(args.device, world)
    try:
        train(args, dp)
    finally:
        dp.close()


def train(args, dp=None):
    """The training run of parsed `args`, data-parallel over `dp` (a
    core/mesh.DataParallel) when given."""
    from construction_clip_tpu_torch.data.datasets import CaptionPairDataset

    world = dp.world if dp is not None else 1
    fit(args, dp, lambda split: CaptionPairDataset(args.json_path, key=args.key, split=split,
                                                   train_ratio=args.train_ratio),
        items_per_batch=args.batch_size * world, run_name=args.output_prefix)


if __name__ == "__main__":
    main()
