"""Corpus scoring: WER and BLEU (a copy of simulst_tpu/decode/scoring.py
without sacrebleu, which the port does not depend on).

BLEU is sacrebleu's corpus_bleu with its defaults, written out: each
segment tokenized by the 13a tokenizer (mteval-v13a, `tokenize_13a`),
summable n-gram statistics over the tokens, exponential smoothing, 0
where no n-gram matches.  The JAX package calls sacrebleu where it is
installed, so both score the same text alike, punctuation and the
decoder's "<unk>" included.
"""
from __future__ import annotations

import math
import re
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


def bleu_from_stats(counts, totals, sys_len, ref_len):
    """BLEU from the statistics, as sacrebleu's compute_bleu with its
    default smooth_method 'exp' (each order with no match doubles an
    accumulator m and scores 100 / (m total)), in its order of
    operations."""
    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * 4
    if not any(int(c) for c in counts):
        return 0.0
    smooth_mteval = 1.0
    for n in range(4):
        c, t = int(counts[n]), int(totals[n])
        if t == 0:
            break
        if c == 0:
            smooth_mteval *= 2
            precisions[n] = 100.0 / (smooth_mteval * t)
        else:
            precisions[n] = 100.0 * c / t
    # sacrebleu's floored log: an order left at 0 scores exp(-huge) = 0
    return bp * math.exp(
        sum([math.log(p) if p != 0.0 else -9999999999
             for p in precisions]) / 4)


# mteval-v13a's language-independent rules, as sacrebleu's Tokenizer13a
_RULES_13A = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),      # . , not after a digit
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),      # . , not before one
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),           # - after a digit
)


def tokenize_13a(line: str) -> str:
    """sacrebleu's 13a tokenization of one segment."""
    line = line.replace("<skipped>", "").replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = line.replace("&quot;", '"').replace("&amp;", "&")
        line = line.replace("&lt;", "<").replace("&gt;", ">")
    line = f" {line} "
    for rule, repl in _RULES_13A:
        line = rule.sub(repl, line)
    return " ".join(line.split())


def corpus_bleu(refs: List[str], hyps: List[str]) -> float:
    """sacrebleu.corpus_bleu(hyps, [refs]).score."""
    return bleu_from_stats(*bleu_stats(
        [tokenize_13a(r.rstrip()) for r in refs],
        [tokenize_13a(h.rstrip()) for h in hyps]))


def score_stats(refs: List[str], hyps: List[str]):
    """The sufficient statistics of corpus BLEU (on 13a tokens, as
    `corpus_bleu`) and WER as one float64 tensor, summable over shards of
    the corpus: [matched n-grams (4), hypothesis n-grams (4), hypothesis
    length, reference length, word errors, reference words, segments]."""
    import torch
    counts, totals, sys_len, ref_len = bleu_stats(
        [tokenize_13a(r.rstrip()) for r in refs],
        [tokenize_13a(h.rstrip()) for h in hyps])
    err, words = wer_counts(refs, hyps)
    return torch.tensor([*counts, *totals, sys_len, ref_len, err, words,
                         len(refs)], dtype=torch.float64)


def scores_from_stats(stats) -> dict:
    """{"bleu": corpus BLEU, "wer": WER} of `score_stats` statistics
    (summed over shards: the scores of the whole corpus)."""
    s = [int(v) for v in stats.tolist()]
    return {"bleu": bleu_from_stats(s[0:4], s[4:8], s[8], s[9]),
            "wer": 100.0 * s[10] / max(s[11], 1)}
