"""Caption quality metrics (the port's copy of construction_clip_tpu/infer/score.py;
the standard library only).

Reference scoring (reference CLIP_prefix_caption/score.py:8-30): char-level sentence
BLEU with nltk SmoothingFunction().method1 over `output_log.json` pairs; the rouge()
function is an abandoned stub (loads ckiptagger word segmentation and stops).

Here: a self-contained BLEU implementation pinned against nltk's numerics in tests
(nltk stays optional), plus working ROUGE-1/2/L — the metric the reference intended.
Char-level tokenization is the default because the captions are Chinese.
"""

from __future__ import annotations

import collections
import math
from typing import Iterable, Sequence


def _ngrams(seq: Sequence, n: int):
    return [tuple(seq[i: i + n]) for i in range(len(seq) - n + 1)]


def sentence_bleu(references: Sequence[Sequence], hypothesis: Sequence,
                  weights=(0.25, 0.25, 0.25, 0.25), *, smoothing: str = "method1"):
    """nltk-compatible sentence BLEU (smoothing method1: add epsilon=0.1 to zero
    numerators). references: list of token sequences; hypothesis: token sequence."""
    if len(hypothesis) == 0:
        return 0.0
    p_log_sum = 0.0
    for i, w in enumerate(weights, start=1):
        if w == 0:
            continue
        hyp_ngrams = collections.Counter(_ngrams(hypothesis, i))
        if not hyp_ngrams:
            return 0.0
        max_counts: collections.Counter = collections.Counter()
        for ref in references:
            ref_ngrams = collections.Counter(_ngrams(ref, i))
            for g, c in ref_ngrams.items():
                max_counts[g] = max(max_counts[g], c)
        clipped = sum(min(c, max_counts.get(g, 0)) for g, c in hyp_ngrams.items())
        total = sum(hyp_ngrams.values())
        if clipped == 0:
            if smoothing == "method1":
                clipped = 0.1
            else:
                return 0.0
        p_log_sum += w * math.log(clipped / total)
    # brevity penalty: closest reference length (ties -> shorter)
    hyp_len = len(hypothesis)
    ref_len = min((abs(len(r) - hyp_len), len(r)) for r in references)[1]
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(p_log_sum)


def char_bleu(reference: str, hypothesis: str, **kw) -> float:
    """Char-level BLEU — the reference's metric (score.py:14-20 tokenizes by list())."""
    return sentence_bleu([list(reference)], list(hypothesis), **kw)


def _lcs(a: Sequence, b: Sequence) -> int:
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, start=1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def _f1(match: float, hyp_n: int, ref_n: int, beta2: float = 1.0) -> float:
    if hyp_n == 0 or ref_n == 0 or match == 0:
        return 0.0
    p, r = match / hyp_n, match / ref_n
    return (1 + beta2) * p * r / (r + beta2 * p)


def rouge_n(reference: Sequence, hypothesis: Sequence, n: int = 1) -> float:
    ref_c = collections.Counter(_ngrams(reference, n))
    hyp_c = collections.Counter(_ngrams(hypothesis, n))
    match = sum(min(c, ref_c.get(g, 0)) for g, c in hyp_c.items())
    return _f1(match, max(len(hypothesis) - n + 1, 0), max(len(reference) - n + 1, 0))


def rouge_l(reference: Sequence, hypothesis: Sequence) -> float:
    return _f1(_lcs(reference, hypothesis), len(hypothesis), len(reference))


def score_pairs(pairs: Iterable[tuple[str, str]]) -> dict:
    """[(reference_caption, generated_caption)] -> corpus-mean metrics, char level."""
    bleus, r1, r2, rl = [], [], [], []
    n = 0
    for ref, hyp in pairs:
        bleus.append(char_bleu(ref, hyp))
        r1.append(rouge_n(list(ref), list(hyp), 1))
        r2.append(rouge_n(list(ref), list(hyp), 2))
        rl.append(rouge_l(list(ref), list(hyp)))
        n += 1
    if n == 0:
        return {"bleu": 0.0, "rouge1": 0.0, "rouge2": 0.0, "rougeL": 0.0, "n": 0}
    return {"bleu": sum(bleus) / n, "rouge1": sum(r1) / n,
            "rouge2": sum(r2) / n, "rougeL": sum(rl) / n, "n": n}
