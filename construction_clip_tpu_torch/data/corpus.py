"""Chinese caption segmentation (the port's host copy of the part of
construction_clip_tpu/data/corpus.py that apps/export_embeddings.py runs):
`tokenize_zh` and the token filter it calls. The rest of that module (the
tokenizer-training corpus: PDFs, the crawler) is not ported yet.

spaCy zh is not available, so `tokenize_zh` groups consecutive CJK
characters into word candidates, splits them at punctuation and at the
excluded characters 一 and ○, splits other scripts on whitespace, lowercases,
and then applies the reference's filter (corpus.py:16-22): tokens with a
latin letter, digit-only tokens, tokens with internal spaces and tokens
holding an excluded punctuation string are dropped.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List

# tokens CONTAINING any of these are dropped (一 and the ○ and box-drawing
# glyphs are in the list: the reports render tables into the text layer)
EXCLUDE_PUNCTUATION = (
    "、", "，", "，，", ",", "。", "？", "！", "(", ")", "（", "）", "「", "」",
    "：", "；", "[", "]", "《", "》", "@", ":", ".", "/", "〈", "〉", "_", "#",
    "~", "-", "─", "┌", "│", "┤", "┐", "└", "┘", "┼", "├", "─", "、", "──",
    "├─", "││", "─┼", "┼─", "┤│", "│├", "─┬", "一", "○", "○○", "○○○",
)


def filter_tokens(tokens: Iterable[str]) -> List[str]:
    """Drop any token containing a latin letter, digit-only tokens, tokens
    with internal spaces, and tokens containing an excluded punctuation
    string."""
    out = []
    for t in tokens:
        if not t or not t.strip():
            continue
        if any("a" <= c.lower() <= "z" for c in t):
            continue
        if t.isdigit():
            continue
        if " " in t:
            continue
        if any(ex in t for ex in EXCLUDE_PUNCTUATION):
            continue
        out.append(t)
    return out


def tokenize_zh(text: str) -> List[str]:
    """CJK-run segmentation: consecutive CJK characters group into word
    candidates, other scripts split on whitespace; lowercased, split at
    punctuation and at 一/○ (so that one such character drops itself and not
    its whole clause), then filtered."""
    runs: List[str] = []
    cur = ""
    cur_cjk = None
    for ch in text.lower():
        is_cjk = "一" <= ch <= "鿿"
        if ch.isspace():
            if cur:
                runs.append(cur)
            cur, cur_cjk = "", None
        elif cur_cjk is None or is_cjk == cur_cjk:
            cur += ch
            cur_cjk = is_cjk
        else:
            runs.append(cur)
            cur, cur_cjk = ch, is_cjk
    if cur:
        runs.append(cur)
    split_runs: List[str] = []
    for r in runs:
        word = ""
        for ch in r:
            if (unicodedata.category(ch).startswith("P")
                    or ch in "：。，、；！？（）「」一○"):
                if word:
                    split_runs.append(word)
                word = ""
            else:
                word += ch
        if word:
            split_runs.append(word)
    return filter_tokens(split_runs)
