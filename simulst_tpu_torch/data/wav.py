"""WAV reading for the streaming evaluator (a copy of
simulst_tpu/data/mustc.py `read_wav`)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def read_wav(path: str, keep_int16: bool = False) -> Tuple[np.ndarray, int]:
    """(samples, sample rate): 16-bit PCM as fp32 in [-1, 1), or kept as
    int16 with keep_int16 (OnlineFbank converts it exactly); other sample
    types as fp32; the first channel of a multichannel file."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        if not keep_int16:
            data = data.astype(np.float32) / 32768.0
    elif data.dtype != np.float32:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data[:, 0]
    return data, sr
