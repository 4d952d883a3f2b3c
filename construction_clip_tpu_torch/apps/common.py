"""What the port's apps share: the --device flag, CLIP weights, the
tokenizers and the corpus stream."""

from __future__ import annotations

import os

import torch


def add_device_flag(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; an error where no CUDA device works) or cpu")


def resolve_device(name: str) -> torch.device:
    """The device --device names. A CUDA device that does not work is an
    error, never a quiet move to the CPU."""
    device = torch.device(name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"--device {name}: the port runs on cuda or cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no usable CUDA device "
                           "(torch.cuda.is_available() is false); pass --device cpu "
                           "to run on the CPU")
    return device


def load_clip(checkpoint: str | None, *, arch: str = "vit_b_32"):
    """(numpy params tree, CLIPConfig): the .npz that either package writes,
    checked against the shapes of `arch`, or random weights from seed 0 when
    `checkpoint` is None. The JAX apps' .pt loading (OpenAI/HF state dicts)
    is not ported."""
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import CLIPConfig
    from construction_clip_tpu_torch.train.checkpoint import load_params_npz

    cfg = getattr(CLIPConfig, arch)()
    if checkpoint is None:
        return convert.init_clip(0, cfg), cfg
    if not checkpoint.endswith(".npz"):
        raise ValueError(f"{checkpoint}: the port reads .npz CLIP checkpoints only")
    return load_params_npz(checkpoint, convert.init_clip(convert.SHAPES, cfg)), cfg


def load_clip_tokenizer(merges_path: str | None, *, expect_vocab: int | None = None):
    """The CLIP BPE tokenizer from `merges_path` or the usual places."""
    from construction_clip_tpu_torch.data.clip_tokenizer import ClipTokenizer

    candidates = [merges_path] if merges_path else []
    candidates += [os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
                   "bpe_simple_vocab_16e6.txt.gz"]
    for c in candidates:
        if c and os.path.exists(c):
            tok = ClipTokenizer(c)
            if expect_vocab is not None and tok.vocab_size != expect_vocab:
                raise ValueError(f"tokenizer vocab {tok.vocab_size} != model text vocab "
                                 f"{expect_vocab} (merges file {c})")
            return tok
    raise FileNotFoundError("CLIP BPE merges file not found; pass --clip_bpe")


def stream_corpus(annotations, image_root: str, batch_size: int, *, stage_size: int = 256):
    """(annotations, staged uint8 [n, S, S, 3]) batches over a corpus; images
    that cannot be read are skipped, as the reference does (apps/common.py's
    stream_corpus)."""
    import numpy as np

    from construction_clip_tpu_torch.data.pipeline import default_load_image, host_shape_unify

    imgs, anns = [], []
    for a in annotations:
        try:
            img = default_load_image(os.path.join(image_root, a.file_name))
        except (FileNotFoundError, OSError) as e:
            print(f"skip {a.file_name}: {e}")
            continue
        imgs.append(host_shape_unify(img, stage_size))
        anns.append(a)
        if len(imgs) == batch_size:
            yield anns, np.stack(imgs)
            imgs, anns = [], []
    if imgs:
        yield anns, np.stack(imgs)


class TokenizerFile:
    """encode/decode over a local tokenizer file: a `tokenizers` JSON, or a
    BERT vocab.txt (the captioner's bert-base-chinese vocabulary)."""

    def __init__(self, path: str):
        if path.endswith(".json"):
            from tokenizers import Tokenizer

            self._tok = Tokenizer.from_file(path)
        else:
            from tokenizers import BertWordPieceTokenizer

            self._tok = BertWordPieceTokenizer(path)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text).ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=skip_special_tokens)

    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()
