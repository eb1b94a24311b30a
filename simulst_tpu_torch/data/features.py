"""Feature transforms: utterance and global CMVN and the global statistics
(a copy of simulst_tpu/data/features.py; numpy, host side).  Global
statistics are written to and read from the data directory's
gcmvn.npz."""
from __future__ import annotations

import numpy as np


def utterance_cmvn(feats: np.ndarray, norm_means=True, norm_vars=True):
    mean = feats.mean(axis=0)
    std = feats.std(axis=0)
    if norm_means:
        feats = feats - mean
    if norm_vars:
        feats = feats / np.maximum(std, 1e-10)
    return feats.astype(np.float32)


def compute_global_cmvn(feature_iter):
    """Global mean / std over an iterator of (T, F) features, the std
    floored at sqrt(1e-8)."""
    n, s, s2 = 0, None, None
    for f in feature_iter:
        if s is None:
            s = f.sum(axis=0)
            s2 = (f ** 2).sum(axis=0)
        else:
            s += f.sum(axis=0)
            s2 += (f ** 2).sum(axis=0)
        n += f.shape[0]
    mean = s / n
    var = s2 / n - mean ** 2
    return {"mean": mean.astype(np.float32),
            "std": np.sqrt(np.maximum(var, 1e-8)).astype(np.float32)}


def global_cmvn(feats, stats):
    return ((feats - stats["mean"]) / stats["std"]).astype(np.float32)
