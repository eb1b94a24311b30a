"""Seeded synthetic token batches for MT training on the card, until real
MuST-C / WMT text is in the repository."""
from __future__ import annotations

from typing import Dict

import numpy as np

from simulst_tpu_torch.data.vocab import EOS, PAD


def synthetic_pairs(rng: np.random.RandomState, n: int, lo: int, hi: int,
                    vocab: int) -> Dict[str, np.ndarray]:
    """n sentence pairs of lo..hi tokens each (EOS last, ids drawn from
    4..vocab-1), right-padded to hi: src_tokens, target and prev_tokens
    (EOS moved to the front), int64 (n, hi)."""
    src = np.full((n, hi), PAD, np.int64)
    tgt = np.full((n, hi), PAD, np.int64)
    prev = np.full((n, hi), PAD, np.int64)
    for j in range(n):
        ls, lt = rng.randint(lo, hi + 1, size=2)
        src[j, :ls] = np.append(rng.randint(4, vocab, ls - 1), EOS)
        tgt[j, :lt] = np.append(rng.randint(4, vocab, lt - 1), EOS)
        prev[j, :lt] = np.append(EOS, tgt[j, :lt - 1])
    return {"src_tokens": src, "target": tgt, "prev_tokens": prev}
