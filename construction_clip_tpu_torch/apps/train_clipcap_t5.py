"""ClipCap mT5 caption training (the port's counterpart of apps/train_clipcap_t5.py,
the CLIP_prefix_caption/train_t5.py entry point), on one device or data-parallel:

    python -m construction_clip_tpu_torch.apps.train_clipcap_t5 --data embedding.npz \\
        --tokenizer chinese_bpe.json --out_dir models --prefix t5_prefix
    torchrun --nproc_per_node 4 -m construction_clip_tpu_torch.apps.train_clipcap_t5 \\
        --data embedding.npz --tokenizer chinese_bpe.json --bs 10

Same flags and defaults as apps/train_clipcap_t5.py (--bs 40, --max_length 32,
--lr 1e-4, --warmup_steps 5000, mT5-small, bf16), except that --tokenizer is a
local `tokenizers` JSON (apps/train_tokenizer.py's output) and --resume names
a checkpoint directory of this package. --data is the .npz archive that either
package's parse_corpus writes (or the reference's .pkl); the prefix width comes
from it. Each caption is tokenised and cut to --max_length ids, zero-padded,
and is both the encoder's input and the target. The T5 vocab grows to cover the
tokenizer before the params are made (apps/common.fit_t5_vocab), as in the JAX
app. It trains on --device: `cuda` (the default; an error where no CUDA device
works) or `cpu`, in --precision. The step is train/t5.py's: only the mapper
with --only_prefix, else the mapper and T5.

The random init is the port's own: convert.init_clipcap_t5 from numpy seed 567,
at the JAX package's shapes and scales but not the values of the JAX app's
jax.random.key(567). --t5_checkpoint starts T5 from a HF (m)T5 state dict (.pt
or .bin, models/t5.from_hf_state_dict), as the JAX app does. --mapping_type
transformer trains the transformer mapper (--num_layers blocks over
--prefix_length_clip projected rows and the prefix constant; width 512, 8
heads, dh 64: K1 and K3 on the card's tensor cores in bf16).

Every epoch is a resumable unit, `<out_dir>/<prefix>/step_<epoch>.pt`, and a
rerun resumes from the latest. At the end it writes `<out_dir>/<prefix>.npz`
with the {mapper, t5} keys that either package's predict_t5 reads.

Under `torchrun` (WORLD_SIZE > 1) every rank trains a replica on
cuda:LOCAL_RANK (or on the CPU with --device cpu) on --bs rows of each global
batch of --bs x world rows, as the JAX app's --bs x devices; the loss is the
global batch's token mean and the gradients are summed over the ranks
(train/t5.py), and rank 0 alone prints, logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import (
    TokenizerFile, add_device_flag, fit_t5_vocab, resolve_device)
from construction_clip_tpu_torch.apps.train_clip import join_world
from construction_clip_tpu_torch.apps.train_clipcap import fit

INIT_SEED = 567


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="./embedding/ViT-B_32_train_embedding.npz")
    p.add_argument("--out_dir", default="./models")
    p.add_argument("--prefix", default="t5_prefix_ct")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--prefix_length", type=int, default=20)
    p.add_argument("--prefix_length_clip", type=int, default=20)
    p.add_argument("--bs", type=int, default=40, help="rows a rank takes of each batch")
    p.add_argument("--only_prefix", action="store_true")
    p.add_argument("--mapping_type", default="mlp")
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--normalize_prefix", action="store_true")
    p.add_argument("--tokenizer", default="chinese_bpe.json",
                   help="a tokenizers JSON file (apps/train_tokenizer.py's output)")
    p.add_argument("--max_length", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--t5_size", default="small", choices=["small", "tiny"])
    p.add_argument("--t5_checkpoint", default=None,
                   help="HF (m)T5 .pt/.bin state dict to start T5 from")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--resume", default=None, help="checkpoint dir of this package")
    p.add_argument("--log_dir", default="log")
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


def tokenize_captions(captions, tokenizer, max_length: int) -> dict:
    """input_ids [N, max_length] int32 (each caption's ids cut to max_length,
    zero-padded) and their attention_mask, as the JAX app builds them."""
    import numpy as np

    ids = np.zeros((len(captions), max_length), np.int32)
    for i, c in enumerate(captions):
        enc = tokenizer.encode(str(c))[:max_length]
        ids[i, :len(enc)] = enc
    return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int32)}


def train(args, dp=None):
    """The training run of parsed `args`, data-parallel over `dp` (a
    core/mesh.DataParallel) when given."""
    import numpy as np
    import torch

    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import ClipCapConfig, T5Config
    from construction_clip_tpu_torch.core.precision import policy_from_name
    from construction_clip_tpu_torch.infer.precompute import load_archive
    from construction_clip_tpu_torch.train.t5 import make_t5_caption_train_step

    device = dp.device if dp is not None else resolve_device(args.device)
    world = dp.world if dp is not None else 1
    main_rank = dp is None or dp.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    policy = policy_from_name(args.precision)

    tokenizer = TokenizerFile(args.tokenizer)
    tcfg = fit_t5_vocab(T5Config() if args.t5_size == "small" else T5Config.tiny(), tokenizer)
    archive = load_archive(args.data)
    arrays = tokenize_captions(archive["captions"], tokenizer, args.max_length)
    arrays["prefix"] = np.asarray(archive["embeddings"], np.float32)
    if args.normalize_prefix:
        n = np.linalg.norm(arrays["prefix"], axis=-1, keepdims=True)
        arrays["prefix"] = arrays["prefix"] / np.maximum(n, 1e-6)
    ccfg = ClipCapConfig(prefix_length=args.prefix_length, attribute_length=0,
                         clip_dim=int(arrays["prefix"].shape[-1]), mapper=args.mapping_type,
                         mapper_layers=args.num_layers, clip_length=args.prefix_length_clip,
                         only_prefix=args.only_prefix)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device: {device} ({name}), {world} data-parallel rank(s)")
    say(f"{len(arrays['prefix'])} items, caption len {args.max_length}, "
        f"t5 vocab {tcfg.vocab_size}")

    t5_tree = None
    if args.t5_checkpoint:
        from construction_clip_tpu_torch.models.clip.convert import load_torch_checkpoint
        from construction_clip_tpu_torch.models.t5 import from_hf_state_dict

        t5_tree = from_hf_state_dict(load_torch_checkpoint(args.t5_checkpoint), tcfg)
    # every rank draws the same init from the seed
    tree = convert.init_clipcap_t5(INIT_SEED, ccfg, tcfg, t5_params=t5_tree)
    del t5_tree
    if args.only_prefix:
        say("Train only prefix")
        params = convert.to_params(tree["mapper"], device=device, trainable=True)
        t5 = convert.to_params(tree["t5"], device=device).tree()
        frozen = policy.cast_to_compute(t5)   # once: the steps take it as it is
    else:
        say("Train both prefix and T5")
        params, frozen = convert.to_params(tree, device=device, trainable=True), None
    del tree

    fit(args, lambda tx: make_t5_caption_train_step(ccfg, tcfg, tx, policy=policy,
                                                    device=device, dp=dp),
        params, frozen, arrays, device=device, dp=dp,
        frozen_tree={"t5": t5} if args.only_prefix else None)

if __name__ == "__main__":
    main()
