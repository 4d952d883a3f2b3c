"""Show-attend-tell eval and visualization (the port's counterpart of
apps/eval_attention.py, the attention_model/test.py entry point): greedy
captions of the corpus's first --limit readable images, each with a figure of
its 7x7 attention alphas over the image, one panel a generated word:

    python -m construction_clip_tpu_torch.apps.eval_attention --json_path all.json \\
        --image_root images/ --checkpoint models/attention --limit 5

Same flags and defaults as apps/eval_attention.py, plus --device (`cuda` by
default; an error where no CUDA device works; or `cpu`). --checkpoint is the
directory train_attention writes (its latest epoch); without it the
captioner is train_attention's random init. The vocabulary is rebuilt from
--json_path at --freq_threshold, as training built it.

`make_captioner` is the per-image function (staged uint8 in, the words and
the alphas out); the figures are drawn with matplotlib, imported only when
one is saved.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from construction_clip_tpu_torch.apps.common import add_device_flag, resolve_device
from construction_clip_tpu_torch.apps.train_attention import (init_captioner, load_corpus,
                                                               load_encoder, make_encoder)

STAGE_SIZE = 256   # host_shape_unify, as the loader stages training images


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../all.json")
    p.add_argument("--image_root", default="../")
    p.add_argument("--checkpoint", required=False, default=None,
                   help="checkpoint directory of this package's train_attention")
    p.add_argument("--resnet_checkpoint", default=None)
    p.add_argument("--embed_size", type=int, default=300)
    p.add_argument("--attention_dim", type=int, default=256)
    p.add_argument("--decoder_dim", type=int, default=512)
    p.add_argument("--freq_threshold", type=int, default=5)
    p.add_argument("--max_len", type=int, default=20)
    p.add_argument("--limit", type=int, default=5)
    p.add_argument("--output_dir", default="output/attention_model")
    add_device_flag(p)
    return p.parse_args(argv)


def make_captioner(enc_params, params, vocab, *, max_len: int):
    """image_u8 [S, S, 3] (host_shape_unify'd) -> (words, alphas [max_len, N]
    numpy): the ResNet-50 grid in fp32, then generate_caption's greedy decode;
    the words are the tokens up to and including eos."""
    import torch

    from construction_clip_tpu_torch.core.params import as_tree, tree_leaves
    from construction_clip_tpu_torch.models.lstm_captioner import generate_caption

    params = as_tree(params)
    device = tree_leaves(params)[0].device
    encode = make_encoder(enc_params)
    sos, eos = vocab.stoi["<SOS>"], vocab.stoi["<EOS>"]

    def caption(image_u8):
        feats = encode(torch.from_numpy(np.ascontiguousarray(image_u8[None])).to(device))
        toks, lengths, alphas = generate_caption(params, feats, sos_id=sos, eos_id=eos,
                                                 max_len=max_len)
        toks = toks[0, :int(lengths[0])].tolist()
        return [vocab.itos.get(int(t), "<UNK>") for t in toks], alphas[0].cpu().numpy()

    return caption


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    from construction_clip_tpu_torch.data.pipeline import default_load_image, host_shape_unify
    from construction_clip_tpu_torch.train.checkpoint import restore_state
    from construction_clip_tpu_torch.train.state import TrainState, adam

    anns, _, vocab = load_corpus(args.json_path, args.freq_threshold)
    params = init_captioner(args, len(vocab), device)
    if args.checkpoint:
        params = restore_state(args.checkpoint, TrainState.create(params, adam(1e-3))).params
    caption = make_captioner(load_encoder(args.resnet_checkpoint, device), params, vocab,
                             max_len=args.max_len)

    os.makedirs(args.output_dir, exist_ok=True)
    done = 0
    for a in anns:
        if done >= args.limit:
            break
        try:
            img = default_load_image(os.path.join(args.image_root, a.file_name))
        except (FileNotFoundError, OSError) as e:
            print(f"skip {a.file_name}: {e}")
            continue
        u8 = host_shape_unify(img, STAGE_SIZE)
        words, alphas = caption(u8)
        print(f"{a.file_name}: {' '.join(words)}")
        save_overlays(u8, words, alphas, os.path.join(
            args.output_dir, os.path.basename(a.file_name) + ".attn.png"))
        done += 1


def save_overlays(image_u8, words, alphas, out_path):
    """Per-word alpha overlays in one figure (reference test.py:43-72): each
    word's alphas as a side x side map, upsampled bilinearly with half-pixel
    centres to the image (jax.image.resize's "bilinear")."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from construction_clip_tpu_torch.infer.explain import resize_bilinear

    n = max(len(words), 1)
    cols = min(n, 5)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    side = int(round(alphas.shape[-1] ** 0.5))
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i >= len(words):
            continue
        heat = resize_bilinear(alphas[i][: side * side].reshape(side, side),
                               (image_u8.shape[0], image_u8.shape[1]))
        ax.imshow(image_u8)
        ax.imshow(heat, alpha=0.6, cmap="jet")
        ax.set_title(words[i])
    fig.tight_layout()
    fig.savefig(out_path, dpi=90)
    plt.close(fig)


if __name__ == "__main__":
    main()
