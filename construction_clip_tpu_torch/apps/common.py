"""What the port's apps share: the --device flag and the tokenizers."""

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
