"""GPT-2 word-embedding PCA export (the port's counterpart of
apps/export_embeddings.py, the CLIP_prefix_caption/export_prediction.py entry
point): the --top_k most frequent caption words of a corpus (data/corpus.py's
tokenize_zh), each word's token rows of GPT-2's wte projected with a 1-D PCA,
written as "word v1 ... v{n_embd}" lines.

    python -m construction_clip_tpu_torch.apps.export_embeddings --json_path all.json \\
        --tokenizer vocab.txt --gpt_checkpoint gpt2.bin --out gpt2_embeddings.txt

The flags and output are the JAX app's, except that --tokenizer is a local
BERT vocab.txt (or a directory holding one, or a `tokenizers` JSON),
`vocab.txt` by default. --gpt_checkpoint is a HF GPT-2 state dict
(models/gpt2.from_hf_state_dict); without one, GPT-2 is the port's random
init from numpy seed 0 (the JAX app draws jax.random.key(0)). The PCA is numpy
on the host: no device runs.
"""

from __future__ import annotations

import argparse
import collections

import numpy as np

from construction_clip_tpu_torch.apps.common import TokenizerFile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json_path", default="../fengyu/0_all.json")
    p.add_argument("--tokenizer", default="vocab.txt",
                   help="BERT vocab.txt, a directory holding one, or a tokenizers JSON")
    p.add_argument("--gpt_checkpoint", default=None, help="HF GPT-2 .pt/.bin state dict")
    p.add_argument("--top_k", type=int, default=100)
    p.add_argument("--tiny", action="store_true", help="tiny GPT-2 config (tests)")
    p.add_argument("--out", default="gpt2_embeddings.txt")
    return p.parse_args(argv)


def pca_scores(rows: np.ndarray) -> np.ndarray:
    """rows [n_tok, n_embd] -> [n_embd]: PCA(1) over n_embd samples of n_tok
    features (the transposed matrix, as the reference's fit_transform), the
    sign set so that the largest |score| is positive (sklearn's svd_flip)."""
    vec_t = rows.T
    centered = vec_t - vec_t.mean(axis=0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    scores = centered @ vt[0]
    if scores[np.argmax(np.abs(scores))] < 0:
        scores = -scores
    return scores


def main(argv=None):
    args = parse_args(argv)
    from construction_clip_tpu_torch import convert
    from construction_clip_tpu_torch.core.configs import GPT2Config
    from construction_clip_tpu_torch.data.corpus import tokenize_zh
    from construction_clip_tpu_torch.data.schema import load_annotations

    tokenizer = TokenizerFile(args.tokenizer)
    gcfg = GPT2Config.tiny() if args.tiny else GPT2Config()
    if args.gpt_checkpoint:
        from construction_clip_tpu_torch.models.clip.convert import load_torch_checkpoint
        from construction_clip_tpu_torch.models.gpt2 import from_hf_state_dict

        params = from_hf_state_dict(load_torch_checkpoint(args.gpt_checkpoint), gcfg)
    else:
        params = convert.init_gpt2(0, gcfg)

    freq: collections.Counter = collections.Counter()
    for a in load_annotations(args.json_path):
        text = a.caption or a.violation_list
        if text:
            freq.update(tokenize_zh(text))
    words = freq.most_common(args.top_k)
    if not words:
        print("no tokens found")
        return

    wte = np.asarray(params["wte"])   # [vocab, n_embd]
    written = 0
    with open(args.out, "w", encoding="utf-8") as f:
        for word, _ in words:
            ids = [t for t in tokenizer.encode(word) if 0 <= t < wte.shape[0]]
            if not ids:
                continue
            scores = pca_scores(wte[ids])
            f.write(word + " " + " ".join(str(float(v)) for v in scores) + "\n")
            written += 1
    print(f"wrote {args.out}: {written} words x {wte.shape[1]} PCA scores")


if __name__ == "__main__":
    main()
