"""Word vocabulary for the show-attend-tell captioner (the port's copy of
construction_clip_tpu/data/vocabulary.py; tests/test_torch_host.py holds the
two equal).

Reference (reference attention_model/dataset.py:13-47): specials <PAD>=0, <SOS>=1,
<EOS>=2, <UNK>=3, words admitted at freq_threshold (5), spaCy tokenization. spaCy is
not a dependency, so tokenize() is whitespace+lower with a per-character fallback for
CJK text (reference used spacy zh for the Chinese corpus). utils.Vocab
(CLIP_prefix_caption/utils.py:4-48) duplicates this; one class here.
"""

from __future__ import annotations

import collections
from typing import Iterable, List

PAD, SOS, EOS, UNK = "<PAD>", "<SOS>", "<EOS>", "<UNK>"


def _is_cjk(ch: str) -> bool:
    return "一" <= ch <= "鿿"


def tokenize(text: str) -> List[str]:
    out: List[str] = []
    for word in text.lower().split():
        if any(_is_cjk(c) for c in word):
            out.extend(list(word))  # per-character for CJK
        else:
            out.append(word)
    return out


class Vocabulary:
    def __init__(self, freq_threshold: int = 5):
        self.freq_threshold = freq_threshold
        self.itos = {0: PAD, 1: SOS, 2: EOS, 3: UNK}
        self.stoi = {v: k for k, v in self.itos.items()}

    def __len__(self) -> int:
        return len(self.itos)

    def build_vocabulary(self, sentences: Iterable[str]) -> None:
        freq = collections.Counter()
        for s in sentences:
            freq.update(tokenize(s))
        idx = len(self.itos)
        for word, c in freq.items():
            if c >= self.freq_threshold and word not in self.stoi:
                self.stoi[word] = idx
                self.itos[idx] = word
                idx += 1

    def numericalize(self, text: str) -> List[int]:
        return [self.stoi.get(t, self.stoi[UNK]) for t in tokenize(text)]

    def encode_caption(self, text: str, max_len: int) -> List[int]:
        ids = [self.stoi[SOS]] + self.numericalize(text)[: max_len - 2] + [self.stoi[EOS]]
        return ids + [self.stoi[PAD]] * (max_len - len(ids))

    def decode(self, ids: Iterable[int]) -> str:
        words = []
        for i in ids:
            w = self.itos.get(int(i), UNK)
            if w == EOS:
                break
            if w in (PAD, SOS):
                continue
            words.append(w)
        return " ".join(words)
