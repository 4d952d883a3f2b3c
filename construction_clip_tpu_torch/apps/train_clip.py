"""Contrastive CLIP fine-tune on class-balanced N-way pairs (the port's
counterpart of apps/train_clip.py), on one device or data-parallel:

    python -m construction_clip_tpu_torch.apps.train_clip --json_path all.json \\
        --image_path images/ --arch vit_b_32 --groups_per_batch 4
    torchrun --nproc_per_node 4 -m construction_clip_tpu_torch.apps.train_clip \\
        --json_path all.json --image_path images/ --groups_per_batch 4

Same flags and defaults as apps/train_clip.py, except that --resume names a
checkpoint directory of this package (train/checkpoint.py), --checkpoint takes
the .npz that either package writes, and --native_loader is not ported. It
trains on --device: `cuda` (the default; an error where no CUDA device works)
or `cpu`; each step runs the port's kernels on the card (train/contrastive.py). Every epoch is a
resumable unit: `<output_dir>/<prefix>_comb<N>/step_<epoch>.pt`, and a rerun
resumes from the latest. At the end it writes `<prefix>_latest.npz`, which the
JAX package's apps read as a CLIP checkpoint.

Under `torchrun` (WORLD_SIZE > 1) every rank trains a replica on
cuda:LOCAL_RANK (or on the CPU with --device cpu): each decodes its own rows
of the global batch of --groups_per_batch groups, the loss is the global
batch's InfoNCE (the features all-gathered by K10), the gradients go through
NCCL (gloo on the CPU) and barriers through gloo, and rank 0 alone prints,
logs and writes the checkpoints. Where the JAX app trains on the largest
number of chips that divides the step batch (groups_per_batch *
combination_num) and notes the rest unused, a torchrun world cannot drop
ranks: a world that does not divide the step batch is an error, and so is a
world larger than the number of CUDA devices (a card is never shared).
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import (
    add_device_flag, load_clip, load_clip_tokenizer, resolve_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../all.json")
    p.add_argument("--image_path", default="../")
    p.add_argument("--key", default="violation_type",
                   choices=["violation_type", "caption_type", "violation_list", "caption"])
    p.add_argument("--combination_num", type=int, default=9)
    p.add_argument("--train_ratio", type=float, default=0.8)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--save_every", type=int, default=100)
    p.add_argument("--groups_per_batch", type=int, default=1)
    p.add_argument("--output_dir", default="models")
    p.add_argument("--output_prefix", default="clip")
    p.add_argument("--checkpoint", default=None, help=".npz params (either package's)")
    p.add_argument("--clip_bpe", default=None, help="path to bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--arch", default="vit_b_32",
                   choices=["vit_b_32", "vit_b_16", "vit_l_14", "tiny", "tiny_bpe"])
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--resume", default=None, help="checkpoint dir of this package")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--native_loader", action="store_true", help="not ported")
    p.add_argument("--watchdog_timeout", type=float, default=600.0,
                   help="seconds without step progress before a stall is logged")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.native_loader:
        raise SystemExit("--native_loader is not ported to construction_clip_tpu_torch")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return train(args)
    dp = join_world(args.device, world)
    try:
        train(args, dp)
    finally:
        dp.close()


def join_world(device_flag: str, world: int):
    """This process's DataParallel in a torchrun world of `world` ranks, on
    cuda:LOCAL_RANK (--device cuda) or the CPU (--device cpu)."""
    import torch

    from construction_clip_tpu_torch.core.mesh import eager_module_loading, init_data_parallel

    if torch.device(device_flag).type == "cuda":
        eager_module_loading()   # before resolve_device's first CUDA call
    device = resolve_device(device_flag)
    if device.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"WORLD_SIZE {world} exceeds the {torch.cuda.device_count()} "
                               "CUDA devices: each rank needs a card of its own")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return init_data_parallel(device=device)


def train(args, dp=None):
    """The training run of parsed `args`, data-parallel over `dp` (a
    core/mesh.DataParallel) when given."""
    import numpy as np
    import torch

    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.mesh import replicate
    from construction_clip_tpu_torch.core.precision import policy_from_name
    from construction_clip_tpu_torch.data.datasets import PairGroupDataset
    from construction_clip_tpu_torch.data.loader import TorchImageTextLoader
    from construction_clip_tpu_torch.data.pipeline import default_load_image
    from construction_clip_tpu_torch.data.preprocess import preprocess_batch
    from construction_clip_tpu_torch.train.checkpoint import (
        latest_step, restore_state, save_params_npz)
    from construction_clip_tpu_torch.train.contrastive import make_eval_step, make_train_step
    from construction_clip_tpu_torch.train.metrics import MetricLogger, StepTimer
    from construction_clip_tpu_torch.train.resilience import StepWatchdog, run_resilient
    from construction_clip_tpu_torch.train.state import TrainState, make_adamw

    device = dp.device if dp is not None else resolve_device(args.device)
    world = dp.world if dp is not None else 1
    main_rank = dp is None or dp.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    step_batch = args.groups_per_batch * args.combination_num
    if step_batch % world:
        raise ValueError(f"step batch {step_batch} (--groups_per_batch x --combination_num) "
                         f"must be divisible by the {world} ranks (raise --groups_per_batch)")
    tree, cfg = load_clip(args.checkpoint, arch=args.arch)
    params = convert.to_params(tree, device=device, trainable=True)
    if dp is not None:
        replicate(dp, params)
    tokenizer = load_clip_tokenizer(
        args.clip_bpe, expect_vocab=cfg.text.vocab_size if args.checkpoint else None)
    policy = policy_from_name(args.precision)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device: {device} ({name}), {world} data-parallel rank(s)")

    def dataset(split):
        return PairGroupDataset(args.json_path, key=args.key, split=split,
                                train_ratio=args.train_ratio,
                                combination_num=args.combination_num)

    def make_loader(ds):
        return TorchImageTextLoader(
            ds, lambda texts: tokenizer.tokenize(texts, cfg.text.context_length),
            batch_size=args.groups_per_batch, device=device, dp=dp,
            load_image=lambda f: default_load_image(os.path.join(args.image_path, f)))

    train_loader, test_loader = make_loader(dataset("train")), make_loader(dataset("test"))
    tx = make_adamw(args.lr, warmup_steps=args.warmup_steps,
                    total_steps=args.epochs * max(len(train_loader), 1))
    step_fn = make_train_step(cfg, tx, policy=policy, device=device, dp=dp)
    eval_fn = make_eval_step(cfg, policy=policy, device=device, dp=dp)

    state = TrainState.create(params, tx)
    if args.resume and latest_step(args.resume) is not None:
        state = restore_state(args.resume, state)
        say(f"resumed from {args.resume} at step {state.step}")

    run_name = f"{args.output_prefix}_comb{args.combination_num}"
    logger = MetricLogger(args.log_dir, run_name) if main_rank else None

    def log(step, **metrics):
        if logger is not None:
            logger.log(step, **metrics)

    timer = StepTimer()
    size = cfg.vision.image_size
    os.makedirs(args.output_dir, exist_ok=True)

    def images(batch):
        return preprocess_batch(batch["images"], size)

    with StepWatchdog(timeout=args.watchdog_timeout) as watchdog:
        def train_epoch(state, epoch):
            m = None
            for batch in train_loader:
                state, m = step_fn(state, {"images": images(batch), "tokens": batch["tokens"]})
                timer.tick()
                watchdog.tick()
                if state.step % 10 == 0:
                    loss, acc = float(m["loss"]), float(m["accuracy"])
                    log(state.step, loss=loss, accuracy=acc, step_time=timer.mean)
                    say(f"epoch {epoch} step {state.step} loss {loss:.4f} acc {acc:.3f} "
                        f"{timer.mean * 1e3:.0f} ms/step")
            if m is None:
                raise RuntimeError(
                    f"epoch {epoch} ran zero steps — dataset produced no groups "
                    f"(need >= {args.combination_num} distinct --key classes)")
            log(state.step, loss=float(m["loss"]), accuracy=float(m["accuracy"]),
                step_time=timer.mean)
            if (epoch + 1) % args.save_every == 0:
                accs = [float(eval_fn(state.params, {"images": images(b),
                                                     "tokens": b["tokens"]}))
                        for b in test_loader]
                log(state.step, test_accuracy=float(np.mean(accs)) if accs else 0.0)
            return state

        state = run_resilient(train_epoch, state, epochs=args.epochs,
                              checkpoint_dir=os.path.join(args.output_dir, run_name),
                              save_every_epochs=args.save_every, dp=dp)
    npz_path = os.path.join(args.output_dir, f"{args.output_prefix}_latest.npz")
    save_params_npz(npz_path, state.params, dp=dp)
    say(f"saved inference params {npz_path}")
    if logger is not None:
        logger.close()


if __name__ == "__main__":
    main()
