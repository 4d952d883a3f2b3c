"""BPE tokenizer training (the port's host copy of apps/train_tokenizer.py, the
CLIP_prefix_caption/train_tokenizer.py entry point): a `tokenizers` BPE with
the Whitespace pre-tokenizer and the specials [UNK] [CLS] [SEP] [PAD] [MASK],
trained on text dumps -> a JSON that train_clipcap_t5 and predict_t5 read.

    python -m construction_clip_tpu_torch.apps.train_tokenizer --input text.txt \\
        --out chinese_bpe.json

It runs on the host alone (no device) and needs the `tokenizers` package, as
the JAX app does.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", default="text.txt", nargs="+")
    p.add_argument("--out", default="chinese_bpe.json")
    p.add_argument("--vocab_size", type=int, default=30000)
    p.add_argument("--min_frequency", type=int, default=2)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    trainer = BpeTrainer(
        vocab_size=args.vocab_size, min_frequency=args.min_frequency,
        special_tokens=["[UNK]", "[CLS]", "[SEP]", "[PAD]", "[MASK]"])
    files = args.input if isinstance(args.input, list) else [args.input]
    tok.train(files, trainer)
    tok.save(args.out)
    print(f"wrote {args.out} (vocab {tok.get_vocab_size()})")


if __name__ == "__main__":
    main()
