"""Corpus scoring: WER and BLEU (a copy of simulst_tpu/decode/scoring.py
without sacrebleu, which the port does not depend on).

BLEU is computed from summable n-gram statistics over whitespace tokens,
with sacrebleu's default exponential smoothing; it equals sacrebleu's
corpus_bleu wherever sacrebleu's 13a tokenizer splits as whitespace does
(text without punctuation, or text already tokenized).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    m, n = len(ref), len(hyp)
    dp = np.arange(n + 1)
    for i in range(1, m + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, n + 1):
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1,
                        prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
    return int(dp[n])


def wer_counts(refs: List[str], hyps: List[str]) -> Tuple[int, int]:
    """(word errors, reference words), summable across shards."""
    err = sum(edit_distance(r.split(), h.split()) for r, h in zip(refs, hyps))
    return err, sum(len(r.split()) for r in refs)


def wer(refs: List[str], hyps: List[str]) -> float:
    e, t = wer_counts(refs, hyps)
    return 100.0 * e / max(t, 1)


def bleu_stats(refs: List[str], hyps: List[str], order: int = 4):
    """(matched n-gram counts, hypothesis n-gram totals, hypothesis length,
    reference length), summable across shards."""
    counts = np.zeros(order, np.int64)
    totals = np.zeros(order, np.int64)
    sys_len = ref_len = 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        sys_len += len(hw)
        ref_len += len(rw)
        for n in range(1, order + 1):
            hn = Counter(tuple(hw[i:i + n]) for i in range(len(hw) - n + 1))
            rn = Counter(tuple(rw[i:i + n]) for i in range(len(rw) - n + 1))
            counts[n - 1] += sum(min(c, rn[g]) for g, c in hn.items())
            totals[n - 1] += max(len(hw) - n + 1, 0)
    return counts, totals, sys_len, ref_len


def bleu_from_stats(counts, totals, sys_len, ref_len, smooth: str = "exp"):
    """BLEU from the statistics, as sacrebleu's compute_bleu with its
    default smooth_method 'exp': each order with no match doubles an
    accumulator m and scores 1 / (m total)."""
    precisions = []
    smooth_mteval = 1.0
    for n in range(4):
        c, t = int(counts[n]), int(totals[n])
        if t == 0:
            return 0.0
        if c == 0:
            if smooth != "exp":
                return 0.0
            smooth_mteval *= 2.0
            precisions.append(1.0 / (smooth_mteval * t))
        else:
            precisions.append(c / t)
    log_p = sum(math.log(p) for p in precisions) / 4
    bp = 1.0 if sys_len > ref_len else (
        math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0)
    return 100.0 * bp * math.exp(log_p)


def corpus_bleu(refs: List[str], hyps: List[str]) -> float:
    return bleu_from_stats(*bleu_stats(refs, hyps))
