"""Feature transforms: utterance and global CMVN (a copy of
simulst_tpu/data/features.py; numpy, host side).  Global statistics are
read from the data directory's gcmvn.npz."""
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


def global_cmvn(feats, stats):
    return ((feats - stats["mean"]) / stats["std"]).astype(np.float32)
