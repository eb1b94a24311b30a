"""Seeded synthetic data until real MuST-C / WMT data is in the
repository: token batches for MT training, and MuST-C-shaped speech
manifests (a copy of simulst_tpu/data/synthetic.py `mustc_like_rows`)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from simulst_tpu_torch.data import manifest as mf
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


def mustc_like_rows(n: int = 3000, seed: int = 0, tmpdir: str = ".",
                    feat_dim: int = 4, chars_per_sec: float = 17.0
                    ) -> List[Dict[str, str]]:
    """Manifest rows (with a real zero-feature zip under tmpdir) whose
    duration / target-length joint distribution is MuST-C en-de shaped:
    lognormal durations around 6 s clipped to 1-20 s, about 17 target
    characters per second with +-25 % noise."""
    rng = np.random.RandomState(seed)
    secs = np.clip(np.exp(rng.normal(1.7, 0.55, n)), 1.0, 20.0)
    frames = (secs * 100).astype(int)
    words = []
    for s in secs:
        n_chars = max(4, int(s * chars_per_sec * rng.uniform(0.75, 1.25)))
        w, left = [], n_chars
        while left > 0:
            wl = int(rng.randint(2, 9))
            w.append("".join(rng.choice(list("abcdefghij"), wl)))
            left -= wl + 1
        words.append(" ".join(w))
    feats = {f"u{i}": np.zeros((int(frames[i]), feat_dim), np.float32)
             for i in range(n)}
    specs = mf.create_feature_zip(feats, os.path.join(tmpdir,
                                                      "synthetic_feats.zip"))
    return [{"id": f"u{i}", "audio": specs[f"u{i}"],
             "n_frames": str(int(frames[i])), "src_text": words[i],
             "tgt_text": words[i], "speaker": "s"} for i in range(n)]
