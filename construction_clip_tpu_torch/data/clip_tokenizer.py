"""CLIP BPE tokenizer (OpenAI vocabulary format), implemented from the algorithm
(the port's copy of construction_clip_tpu/data/clip_tokenizer.py).

The reference tokenizes prompts with `clip.tokenize` (reference CLIP/train.py:57,
predict.py:30), which wraps a byte->printable-unicode BPE over the
`bpe_simple_vocab_16e6.txt.gz` merges file, adds <|startoftext|>/<|endoftext|>,
truncates/pads to context_length 77. This module reimplements that contract:

  - byte_to_unicode: the reversible byte -> printable-unicode-codepoint table
    (printable ASCII + latin-1 ranges map to themselves, the rest shift past 255).
  - vocabulary: 256 byte symbols, 256 byte+'</w>' symbols, one token per merge line,
    then the two specials — 49152 + 256 + 2*... = 49408 for the standard file.
  - word splitting: contraction suffixes, letter runs, single digits, symbol runs
    (the \\p{L}/\\p{N} pattern, implemented with unicodedata so no `regex` dep).
  - greedy lowest-rank pair merging per word, last subword marked '</w>'.

The merges file itself ships with OpenAI CLIP; pass its path (gz or plain). For tests a
tiny synthetic merges file exercises the algorithm end-to-end.
"""

from __future__ import annotations

import functools
import gzip
import html
import unicodedata
from typing import Iterable, List, Sequence

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"


@functools.lru_cache()
def byte_to_unicode() -> dict[int, str]:
    """Map every byte to a printable unicode char, identity on printable ranges."""
    keep = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("\xa1"), ord("\xac") + 1)) + \
        list(range(ord("\xae"), ord("\xff") + 1))
    mapping = {}
    shift = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def word_split(text: str) -> List[str]:
    """Split cleaned text into BPE words, mirroring CLIP's tokenizer regex:
    contraction suffixes | letter runs | single digits | non-space-symbol runs."""
    words: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "'":
            matched = False
            for c in _CONTRACTIONS:
                if text.startswith(c, i):
                    words.append(c)
                    i += len(c)
                    matched = True
                    break
            if matched:
                continue
        if _is_letter(ch):
            j = i
            while j < n and _is_letter(text[j]):
                j += 1
            words.append(text[i:j])
            i = j
        elif _is_number(ch):
            words.append(ch)
            i += 1
        else:
            j = i
            while j < n and not (text[j].isspace() or _is_letter(text[j]) or _is_number(text[j])):
                j += 1
            words.append(text[i:j])
            i = j
    return words


def clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip().lower()


class ClipTokenizer:
    # OpenAI slices merges[1 : 49152-256-2+1] -> 48894 merge rules, giving
    # vocab 256+256+48894+2 = 49408 with sot/eot = 49406/49407.
    N_MERGES_OPENAI = 49152 - 256 - 2

    def __init__(self, merges_path: str, *, n_merges: int | None = N_MERGES_OPENAI):
        if merges_path.endswith(".gz"):
            with gzip.open(merges_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        # first line is a version header; standard file uses merges 1..48894
        merge_lines = [l for l in lines[1:] if l.strip()]
        if n_merges is not None:
            merge_lines = merge_lines[:n_merges]
        merges = [tuple(l.split()) for l in merge_lines]

        b2u = byte_to_unicode()
        symbols = list(b2u.values())
        vocab: List[str] = symbols + [s + "</w>" for s in symbols]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TEXT, EOT_TEXT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = b2u
        self.byte_decoder = {v: k for k, v in b2u.items()}
        self.sot = self.encoder[SOT_TEXT]
        self.eot = self.encoder[EOT_TEXT]
        self._cache: dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # OpenAI-convention aliases (the real-weight hook tests use these names)
    @property
    def sot_token(self) -> int:
        return self.sot

    @property
    def eot_token(self) -> int:
        return self.eot

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = {(parts[i], parts[i + 1]) for i in range(len(parts) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in word_split(clean_text(text)):
            encoded = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(encoded))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids
                       if i not in (self.sot, self.eot))
        # '</w>' is made of printable-ascii chars that byte-decode to themselves, so
        # byte-decode first, then turn the word markers into spaces.
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def tokenize(self, texts: str | Iterable[str], context_length: int = 77,
                 *, truncate: bool = True) -> np.ndarray:
        """[B, context_length] int32: SOT + bpe + EOT, zero-padded — the
        `clip.tokenize` contract the reference relies on."""
        texts = [texts] if isinstance(texts, str) else list(texts)
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"text too long for context {context_length}: {text!r}")
                ids = ids[: context_length - 1] + [self.eot]
            out[row, : len(ids)] = ids
        return out
