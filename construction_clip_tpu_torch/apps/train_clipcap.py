"""ClipCap prefix-caption training (the port's counterpart of apps/train_clipcap.py,
the CLIP_prefix_caption/train.py entry point), on one device or data-parallel:

    python -m construction_clip_tpu_torch.apps.train_clipcap --data embedding.npz \\
        --tokenizer vocab.txt --out_dir models --prefix clipcap
    torchrun --nproc_per_node 4 -m construction_clip_tpu_torch.apps.train_clipcap \\
        --data embedding.npz --tokenizer vocab.txt --bs 8

Same flags and defaults as apps/train_clipcap.py, except that --tokenizer is a
local BERT vocab.txt (or a directory holding one, or a `tokenizers` JSON),
`vocab.txt` by default, and --resume names a checkpoint directory of this
package. --data is the .npz archive that either package's parse_corpus
writes (or the reference's .pkl); the prefix width comes from it (--is_rn
only sets it for an empty archive). It trains on --device: `cuda` (the
default; an error where no CUDA device works) or `cpu`, in --precision (bf16
by default). The step is train/caption.py's: only the mapper with
--only_prefix, else the mapper and GPT-2.

The random init is the port's own: convert.init_clipcap from numpy seed 567,
at the JAX package's shapes and scales but not the values of the JAX app's
jax.random.key(567). --gpt_checkpoint starts GPT-2 from a HF state dict (.pt
or .bin, models/gpt2.from_hf_state_dict), as the JAX app does. --mapping_type
transformer trains the transformer mapper (--num_layers blocks over
--prefix_length_clip projected rows and the prefix constant; at GPT-2's width
768 with 8 heads, dh 96: K1 and K3 on their SIMT route). predict and serve
build it with --prefix_length_clip 10 and 8 layers, as the JAX apps do, so a
checkpoint trained at this app's default --prefix_length_clip 20 does not
load there (in either package: its mapper/proj is [clip_dim, 20 x 768]).

Every epoch is a resumable unit, `<out_dir>/<prefix>/step_<epoch>.pt`, and a
rerun resumes from the latest. At the end it writes `<out_dir>/<prefix>.npz`
with the {mapper, gpt} keys that either package's predict app reads.

Under `torchrun` (WORLD_SIZE > 1) every rank trains a replica on
cuda:LOCAL_RANK (or on the CPU with --device cpu) on --bs rows of each global
batch of --bs x world rows, as the JAX app's --bs x devices; the loss is the
global batch's token mean and the gradients are summed over the ranks
(train/caption.py), and rank 0 alone prints, logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import TokenizerFile, add_device_flag, resolve_device
from construction_clip_tpu_torch.apps.train_clip import join_world

INIT_SEED = 567


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data", default="./embedding/ViT-B_32_train_embedding.npz")
    p.add_argument("--out_dir", default="./models")
    p.add_argument("--prefix", default="coco_prefix_ct", help="prefix for saved filenames")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--prefix_length", type=int, default=20)
    p.add_argument("--attribute_length", type=int, default=20)
    p.add_argument("--prefix_length_clip", type=int, default=20)
    p.add_argument("--bs", type=int, default=1, help="rows a rank takes of each batch")
    p.add_argument("--only_prefix", action="store_true")
    p.add_argument("--mapping_type", type=str, default="mlp", help="mlp/transformer")
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--is_rn", action="store_true")
    p.add_argument("--normalize_prefix", action="store_true")
    p.add_argument("--tokenizer", type=str, default="vocab.txt",
                   help="BERT vocab.txt, a directory holding one, or a tokenizers JSON")
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--gpt_checkpoint", default=None,
                   help="HF GPT-2 .pt/.bin state dict to start the LM from")
    p.add_argument("--gpt_size", default="base", choices=["base", "tiny"],
                   help="tiny = test-scale decoder")
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


def train(args, dp=None):
    """The training run of parsed `args`, data-parallel over `dp` (a
    core/mesh.DataParallel) when given."""
    import numpy as np
    import torch

    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import ClipCapConfig, GPT2Config
    from construction_clip_tpu_torch.core.precision import policy_from_name
    from construction_clip_tpu_torch.infer.precompute import (
        load_archive, tokenize_for_caption_training)
    from construction_clip_tpu_torch.train.caption import make_caption_train_step

    device = dp.device if dp is not None else resolve_device(args.device)
    world = dp.world if dp is not None else 1
    main_rank = dp is None or dp.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    gcfg = GPT2Config() if args.gpt_size == "base" else GPT2Config.tiny()
    policy = policy_from_name(args.precision)

    archive = load_archive(args.data)
    # the prefix width from the archive; the reference's 640-if-RN/512 only for
    # an empty one (train.py:407)
    clip_dim = archive["embeddings"].shape[-1] if len(archive["embeddings"]) \
        else (640 if args.is_rn else 512)
    ccfg = ClipCapConfig(
        prefix_length=args.prefix_length, attribute_length=args.attribute_length,
        clip_dim=int(clip_dim), mapper=args.mapping_type, mapper_layers=args.num_layers,
        clip_length=args.prefix_length_clip, only_prefix=args.only_prefix)
    arrays = tokenize_for_caption_training(archive, TokenizerFile(args.tokenizer),
                                           attribute_length=args.attribute_length)
    if args.normalize_prefix:
        n = np.linalg.norm(arrays["prefix"], axis=-1, keepdims=True)
        arrays["prefix"] = arrays["prefix"] / np.maximum(n, 1e-6)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device: {device} ({name}), {world} data-parallel rank(s)")
    say(f"{len(arrays['prefix'])} items, caption len {arrays['tokens'].shape[1]}")

    gpt_tree = None
    if args.gpt_checkpoint:
        from construction_clip_tpu_torch.models.clip.convert import load_torch_checkpoint
        from construction_clip_tpu_torch.models.gpt2 import from_hf_state_dict

        gpt_tree = from_hf_state_dict(load_torch_checkpoint(args.gpt_checkpoint), gcfg)
    # every rank draws the same init from the seed
    tree = convert.init_clipcap(INIT_SEED, ccfg, gcfg, gpt_params=gpt_tree)
    say("Train only prefix" if args.only_prefix else "Train both prefix and GPT")
    if args.only_prefix:
        params = convert.to_params(tree["mapper"], device=device, trainable=True)
        gpt = convert.to_params(tree["gpt"], device=device).tree()
        frozen = policy.cast_to_compute(gpt)   # once: the steps take it as it is
    else:
        params, frozen = convert.to_params(tree, device=device, trainable=True), None
    del tree

    fit(args, lambda tx: make_caption_train_step(ccfg, gcfg, tx, policy=policy, device=device,
                                                 dp=dp),
        params, frozen, arrays, device=device, dp=dp,
        frozen_tree={"gpt": gpt} if args.only_prefix else None)


def fit(args, make_step, params, frozen, arrays: dict, *, device, dp, frozen_tree):
    """The caption apps' training run (train_clipcap, train_clipcap_t5): AdamW
    with warmup over `params` for --epochs epochs of `arrays` in global
    batches of --bs x ranks, `make_step(tx)`'s step taking (state, frozen,
    batch); every epoch a resumable checkpoint, the loss logged every 50
    steps and at each epoch's end; at the end <out_dir>/<prefix>.npz holds
    the trained params, with the fp32 `frozen_tree` ({"gpt": ...} or
    {"t5": ...}) beside the mapper in only-prefix runs. Rank 0 alone prints,
    logs and writes."""
    from construction_clip_tpu_torch.core.params import as_tree
    from construction_clip_tpu_torch.data.loader import TorchArrayLoader
    from construction_clip_tpu_torch.train.checkpoint import (
        latest_step, restore_state, save_params_npz)
    from construction_clip_tpu_torch.train.metrics import MetricLogger, StepTimer
    from construction_clip_tpu_torch.train.resilience import StepWatchdog, run_resilient
    from construction_clip_tpu_torch.train.state import TrainState, make_adamw

    world = dp.world if dp is not None else 1
    main_rank = dp is None or dp.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    loader = TorchArrayLoader(arrays, batch_size=args.bs * world, device=device, dp=dp)
    tx = make_adamw(args.lr, warmup_steps=args.warmup_steps,
                    total_steps=args.epochs * max(len(loader), 1))
    step_fn = make_step(tx)
    state = TrainState.create(params, tx)
    if args.resume and latest_step(args.resume) is not None:
        state = restore_state(args.resume, state)
        say(f"resumed at step {state.step}")

    os.makedirs(args.out_dir, exist_ok=True)
    logger = MetricLogger(args.log_dir, args.prefix) if main_rank else None

    def log(step, **metrics):
        if logger is not None:
            logger.log(step, **metrics)

    timer = StepTimer()
    with StepWatchdog(timeout=600.0) as watchdog:
        def train_epoch(state, epoch):
            m = None
            for batch in loader:
                state, m = step_fn(state, frozen, batch)
                timer.tick()
                watchdog.tick()
                if state.step % 50 == 0:
                    loss = float(m["loss"])
                    log(state.step, loss=loss, step_time=timer.mean)
                    say(f"epoch {epoch} step {state.step} loss {loss:.4f} "
                        f"{timer.mean * 1e3:.0f} ms/step")
            if m is None:
                raise RuntimeError(
                    f"epoch {epoch} ran zero steps: global batch {args.bs} x {world} "
                    f"ranks > {len(arrays['prefix'])} archive items — lower --bs or "
                    f"the number of ranks")
            # an epoch-end point, so that short runs still record a loss curve
            log(state.step, loss=float(m["loss"]), step_time=timer.mean)
            return state

        state = run_resilient(train_epoch, state, epochs=args.epochs,
                              checkpoint_dir=os.path.join(args.out_dir, args.prefix),
                              save_every_epochs=args.save_every, dp=dp)
    final = as_tree(state.params)
    if frozen_tree is not None:
        final = {"mapper": final, **frozen_tree}
    npz_path = os.path.join(args.out_dir, f"{args.prefix}.npz")
    save_params_npz(npz_path, final, dp=dp)
    say(f"saved inference params {npz_path}")
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
