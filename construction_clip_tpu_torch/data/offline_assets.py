"""Deterministic offline stand-ins for the two tokenizer assets (the port's copy
of the writers in tools/make_offline_assets.py):

  1. a CLIP BPE merges file with exactly 48894 merge rules, so ClipTokenizer
     yields the standard 49408-token vocabulary. The merges are synthetic
     left-linear chains over ASCII letters: token ids differ from the OpenAI
     vocabulary's, so the file serves random or fine-tuned-from-random weights,
     never pretrained OpenAI text towers;
  2. a BERT-style Chinese vocab.txt with exactly 21128 entries (the
     bert-base-chinese size), specials at the canonical ids ([PAD]=0, [UNK]=100,
     [CLS]=101, [SEP]=102, [MASK]=103; 102 is the beam stop token), corpus
     characters as entries, [unusedN] filler to size.
"""

from __future__ import annotations

import gzip
import itertools
import json
import string

from construction_clip_tpu_torch.data.labels import CAPTION_TYPE_PROMPTS, VIOLATION_TYPES

N_MERGES = 49152 - 256 - 2  # 48894, ClipTokenizer.N_MERGES_OPENAI


def write_clip_merges(path: str, n_merges: int = N_MERGES) -> None:
    """Left-linear merge chains: every ASCII-lowercase string of length 2..4
    (lexicographic) contributes the merge (s[:-1], s[-1]); prefixes are always
    generated before their extensions, and each token string is produced by
    exactly one merge, so the vocabulary stays duplicate-free."""
    merges = []
    for length in (2, 3, 4):
        for tup in itertools.product(string.ascii_lowercase, repeat=length):
            s = "".join(tup)
            merges.append(f"{s[:-1]} {s[-1]}")
            if len(merges) == n_merges:
                break
        if len(merges) == n_merges:
            break
    if len(merges) != n_merges:
        raise ValueError(f"at most {len(merges)} merges, not {n_merges}")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic-offline\n")
        f.write("\n".join(merges) + "\n")


def corpus_characters(json_paths) -> list[str]:
    """The label characters and every character of the corpora's text fields."""
    chars = set("".join(VIOLATION_TYPES) + "".join(CAPTION_TYPE_PROMPTS))
    for p in json_paths:
        with open(p, encoding="utf-8") as f:
            data = json.load(f)
        for a in data.get("annotations", []):
            for key in ("caption", "violation_list", "caption_type",
                        "violation_type", "objects"):
                chars.update(a.get(key) or "")
    return sorted(c for c in chars if not c.isspace())


def write_bert_vocab(path: str, chars: list[str], size: int = 21128) -> None:
    """size 21128 = bert-base-chinese; a smaller size keeps the canonical
    special positions and packs as many corpus characters as fit."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)] + \
        ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    if size >= 21128:
        vocab += list(string.ascii_lowercase) + list(string.digits)
    vocab += [c for c in chars if c not in set(vocab)][: size - len(vocab)]
    if size >= 21128:
        # wordpiece continuations for latin/digits (CJK characters are split
        # to single tokens, never need ##)
        vocab += ["##" + c for c in string.ascii_lowercase + string.digits]
    i = 100
    while len(vocab) < size:
        vocab.append(f"[unused{i}]")
        i += 1
    if len(vocab) != size or vocab[102] != "[SEP]":
        raise ValueError(f"vocab of {len(vocab)} entries, [SEP] at {vocab.index('[SEP]')}")
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
