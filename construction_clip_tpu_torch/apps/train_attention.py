"""Show-attend-tell training (the port's counterpart of apps/train_attention.py,
the attention_model/train.py entry point), on one device or data-parallel:

    python -m construction_clip_tpu_torch.apps.train_attention --json_path all.json \\
        --image_root images/ --output_dir models/attention
    torchrun --nproc_per_node 4 -m construction_clip_tpu_torch.apps.train_attention ...

Same flags and defaults as apps/train_attention.py (embed 300, attention 256,
decoder 512, encoder 2048, Adam at lr 3e-4, 25 epochs, batch 32, captions cut
to 32 ids, dropout 0.3), plus --device: `cuda` (the default; an error where no
CUDA device works) or `cpu`. The encoder is a frozen ResNet-50 run in fp32
on each batch (ImageNet normalization at 224 px): torchvision weights from
--resnet_checkpoint (a .pt/.pth state dict), else random weights from
convert.init_resnet50(0). The captioner's random init is the port's own,
convert.init_lstm_captioner from numpy seed 567, at the JAX package's shapes
and scales but not the values of the JAX app's jax.random.key(567).

Every epoch is a resumable checkpoint with the optimizer state,
`<output_dir>/step_<epoch>.pt` (train/resilience.run_resilient); a rerun
resumes from the latest, and --resume starts from another directory's.
eval_attention --checkpoint reads the directory.

Under `torchrun` (WORLD_SIZE > 1) every rank trains a replica on
cuda:LOCAL_RANK (or on the CPU with --device cpu) on its rows of each global
batch of --batch_size rows; the JAX app takes the largest device count that
divides the batch, but a torchrun world is fixed, so a batch it does not
divide is an error. The loss is the global batch's token mean and the
gradients are summed over the ranks (train/lstm.py). Rank 0 alone prints,
logs and writes the checkpoints.
"""

from __future__ import annotations

import argparse
import os

from construction_clip_tpu_torch.apps.common import add_device_flag, resolve_device
from construction_clip_tpu_torch.apps.train_clip import join_world

INIT_SEED = 567       # the captioner (the JAX app's jax.random.key(567))
ENCODER_SEED = 0      # the random ResNet-50 without --resnet_checkpoint
DROPOUT = 0.3         # reference attention_model/model.py's dropout on h


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../all.json")
    p.add_argument("--image_root", default="../")
    p.add_argument("--caption_key", default="caption")
    p.add_argument("--embed_size", type=int, default=300)
    p.add_argument("--attention_dim", type=int, default=256)
    p.add_argument("--decoder_dim", type=int, default=512)
    p.add_argument("--freq_threshold", type=int, default=5)
    p.add_argument("--max_len", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--resnet_checkpoint", default=None,
                   help="torchvision resnet50 state dict (.pth)")
    p.add_argument("--output_dir", default="models/attention")
    p.add_argument("--resume", default=None)
    p.add_argument("--log_dir", default="log")
    add_device_flag(p)
    return p.parse_args(argv)


def load_corpus(json_path: str, freq_threshold: int):
    """(annotations with a caption or a violation list, their texts, the
    Vocabulary built over the texts), as both JAX apps read the corpus."""
    from construction_clip_tpu_torch.data.schema import load_annotations
    from construction_clip_tpu_torch.data.vocabulary import Vocabulary

    anns = [a for a in load_annotations(json_path) if (a.caption or a.violation_list)]
    texts = [a.caption or a.violation_list for a in anns]
    vocab = Vocabulary(freq_threshold)
    vocab.build_vocabulary(texts)
    return anns, texts, vocab


def load_encoder(resnet_checkpoint: str | None, device) -> dict:
    """The frozen ResNet-50 tree on `device`: a torchvision state dict's, or
    convert.init_resnet50(ENCODER_SEED)'s random weights."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.models.resnet import from_torchvision_state_dict

    if resnet_checkpoint:
        from construction_clip_tpu_torch.models.clip.convert import load_torch_checkpoint

        tree = from_torchvision_state_dict(load_torch_checkpoint(resnet_checkpoint))
    else:
        tree = convert.init_resnet50(ENCODER_SEED)
    return convert.to_detector_params(tree, device=device)


def make_encoder(enc_params):
    """uint8 images [B, H, W, 3] (a tensor on the encoder's device) -> the
    fp32 feature grid [B, (224/32)^2, 2048]: ImageNet preprocessing at 224
    px, then resnet50_features."""
    import torch

    from construction_clip_tpu_torch.data.preprocess import (IMAGENET_MEAN, IMAGENET_STD,
                                                             preprocess_batch)
    from construction_clip_tpu_torch.models.resnet import resnet50_features

    @torch.no_grad()   # not inference_mode: the train step saves the grid for backward
    def encode(images_u8):
        x = preprocess_batch(images_u8, 224, mean=IMAGENET_MEAN, std=IMAGENET_STD)
        return resnet50_features(enc_params, x)

    return encode


def init_captioner(args, vocab_size: int, device):
    from construction_clip_tpu_torch import convert

    tree = convert.init_lstm_captioner(INIT_SEED, vocab_size=vocab_size,
                                       embed_size=args.embed_size,
                                       attention_dim=args.attention_dim,
                                       decoder_dim=args.decoder_dim)
    return convert.to_params(tree, device=device, trainable=True)


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


def train(args, dp=None, *, load_image=None):
    """The training run of parsed `args`, data-parallel over `dp` (a
    core/mesh.DataParallel) when given; `load_image(path) -> uint8 HWC` reads
    the images (data/pipeline.default_load_image, PIL, when None). Returns
    the final TrainState."""
    import numpy as np
    import torch

    from construction_clip_tpu_torch.data.loader import TorchImageTextLoader
    from construction_clip_tpu_torch.data.pipeline import default_load_image
    from construction_clip_tpu_torch.train.checkpoint import latest_step, restore_state
    from construction_clip_tpu_torch.train.lstm import make_lstm_train_step
    from construction_clip_tpu_torch.train.metrics import MetricLogger, StepTimer
    from construction_clip_tpu_torch.train.resilience import StepWatchdog, run_resilient
    from construction_clip_tpu_torch.train.state import TrainState, adam

    device = dp.device if dp is not None else resolve_device(args.device)
    world = dp.world if dp is not None else 1
    main_rank = dp is None or dp.rank == 0
    say = print if main_rank else (lambda *a, **k: None)
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} does not split over the {world} "
                         f"ranks of WORLD_SIZE: pick a batch that {world} divides")
    anns, texts, vocab = load_corpus(args.json_path, args.freq_threshold)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    say(f"device: {device} ({name}), {world} data-parallel rank(s)")
    say(f"{len(anns)} captions, vocab {len(vocab)}")

    class Dataset:
        def __len__(self):
            return len(anns)

        def __getitem__(self, i):
            return anns[i].file_name, texts[i]

    def tokenize(batch_texts):
        return np.asarray([vocab.encode_caption(t, args.max_len) for t in batch_texts],
                          dtype=np.int32)

    read = load_image or default_load_image
    loader = TorchImageTextLoader(Dataset(), tokenize, batch_size=args.batch_size,
                                  device=device, dp=dp,
                                  load_image=lambda f: read(os.path.join(args.image_root, f)))
    encode = make_encoder(load_encoder(args.resnet_checkpoint, device))
    tx = adam(args.lr)
    state = TrainState.create(init_captioner(args, len(vocab), device), tx)
    if args.resume and latest_step(args.resume) is not None:
        state = restore_state(args.resume, state)
        say(f"resumed at step {state.step}")
    step_fn = make_lstm_train_step(tx, dp=dp, dropout_rate=DROPOUT)
    logger = MetricLogger(args.log_dir, "attention_model") if main_rank else None
    timer = StepTimer()

    with StepWatchdog(timeout=600.0) as watchdog:
        def train_epoch(state, epoch):
            for batch in loader:
                feats = encode(batch["images"])
                # the dropout stream of step s is seeded with s (and the rank)
                state, m = step_fn(state, {"features": feats, "tokens": batch["tokens"]},
                                   state.step)
                timer.tick()
                watchdog.tick()
                if state.step % 25 == 0:
                    loss = float(m["loss"])
                    if logger is not None:
                        logger.log(state.step, loss=loss, step_time=timer.mean)
                    say(f"epoch {epoch} step {state.step} loss {loss:.4f}")
            return state

        state = run_resilient(train_epoch, state, epochs=args.epochs,
                              checkpoint_dir=args.output_dir, save_every_epochs=1, dp=dp)
    if logger is not None:
        logger.close()
    return state


if __name__ == "__main__":
    main()
