"""Kaldi-compliance 80-dim log-mel filterbank on tensors (counterpart of
simulst_tpu/ops/fbank.py `fbank_batch_jax`), utterance CMVN
(simulst_tpu/data/features.py `utterance_cmvn`) and the streaming agents'
incremental `OnlineFbank`.

Same spec as the JAX package: 16 kHz, 25 ms window / 10 ms shift,
snip_edges, dither 0, DC offset removed, preemphasis 0.97, povey window,
512-point FFT, 80 mel bins over [20 Hz, Nyquist], log with the
float32-epsilon floor; waveforms arrive already scaled by 2**15.  The
framing constants, window and mel banks are computed here in numpy with
the JAX package's formulas (this package imports nothing of it); the
tests hold both equal.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

EPSILON = 1.1920928955078125e-07   # torchaudio kaldi-compliance epsilon
PREEMPHASIS = 0.97


def frame_params(sample_rate: int = 16000, frame_length_ms: float = 25.0,
                 frame_shift_ms: float = 10.0):
    """(window_size, window_shift, padded FFT size) in samples."""
    window_size = int(sample_rate * frame_length_ms * 0.001)
    window_shift = int(sample_rate * frame_shift_ms * 0.001)
    return window_size, window_shift, 1 << (window_size - 1).bit_length()


def num_frames(n_samples: int, sample_rate: int = 16000) -> int:
    window_size, window_shift, _ = frame_params(sample_rate)
    if n_samples < window_size:
        return 0
    return 1 + (n_samples - window_size) // window_shift


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


@functools.lru_cache(maxsize=8)
def mel_banks(num_bins: int, window_length_padded: int, sample_freq: float,
              low_freq: float = 20.0) -> np.ndarray:
    """Kaldi MelBanks triangular weights (num_bins, padded / 2), high
    frequency at Nyquist."""
    fft_bin_width = sample_freq / window_length_padded
    mel_low = _mel_scale(low_freq)
    mel_high = _mel_scale(0.5 * sample_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins)[:, None]
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1) * mel_delta
    right = mel_low + (bins + 2) * mel_delta
    mel = _mel_scale(fft_bin_width * np.arange(window_length_padded // 2)[None, :])
    up = (mel - left) / (center - left)
    down = (right - mel) / (right - center)
    return np.maximum(0.0, np.minimum(up, down)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


def fbank_batch(waveforms, sample_rate: int = 16000, n_mels: int = 80):
    """(B, N) raw samples (already x 2**15) -> (B, T, n_mels) fp32 on the
    waveforms' device.  Framing is by global position (snip_edges): rows
    computed over a caller's zero-padded tail are not zeros and must be
    masked downstream by per-example valid counts."""
    window_size, window_shift, padded = frame_params(sample_rate)
    n = num_frames(waveforms.shape[-1], sample_rate)
    dev = waveforms.device
    if n == 0:
        return torch.zeros(waveforms.shape[0], 0, n_mels, device=dev)
    idx = (torch.arange(n, device=dev)[:, None] * window_shift
           + torch.arange(window_size, device=dev)[None, :])
    x = waveforms.float()[:, idx]                         # (B, T, W)
    x = x - x.mean(dim=-1, keepdim=True)
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)   # kaldi x[max(j-1,0)]
    x = (x - PREEMPHASIS * prev) * torch.as_tensor(povey_window(window_size),
                                                   device=dev)
    x = torch.nn.functional.pad(x, (0, padded - window_size))
    spec = torch.fft.rfft(x, dim=-1).abs() ** 2
    spec = spec[..., : padded // 2]                       # kaldi drops Nyquist
    banks = torch.as_tensor(mel_banks(n_mels, padded, float(sample_rate)),
                            device=dev)
    return torch.log(torch.clamp_min(spec @ banks.T, EPSILON))


def utterance_cmvn(feats):
    """Per-utterance mean/variance normalisation over time, (..., T, F)."""
    mean = feats.mean(dim=-2, keepdim=True)
    std = feats.std(dim=-2, unbiased=False, keepdim=True)
    return (feats - mean) / torch.clamp_min(std, 1e-10)


class OnlineFbank:
    """Incremental fbank for the streaming agents (a copy of the JAX
    package's OnlineFbank over `fbank_batch` on the host): the samples
    that do not fill another frame carry over to the next call, so that
    chunked extraction equals the offline one.  Optional global CMVN
    (mean, std)."""

    def __init__(self, sample_rate: int = 16000, n_mels: int = 80,
                 global_cmvn=None):
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.window_size, self.window_shift, _ = frame_params(sample_rate)
        self.previous_residual = np.zeros((0,), np.float32)
        self.global_cmvn = global_cmvn

    def reset(self):
        self.previous_residual = np.zeros((0,), np.float32)

    def __call__(self, new_samples) -> np.ndarray:
        """new_samples: a waveform in [-1, 1], or int16 PCM (converted by
        the exact power-of-two scale); returns (t, n_mels) fp32."""
        new_samples = np.asarray(new_samples)
        if new_samples.dtype == np.int16:
            new_samples = new_samples.astype(np.float32) / (2 ** 15)
        samples = np.concatenate([self.previous_residual,
                                  np.asarray(new_samples, np.float32)])
        n = num_frames(len(samples), self.sample_rate)
        if n == 0:
            self.previous_residual = samples
            return np.zeros((0, self.n_mels), np.float32)
        consumed = n * self.window_shift
        self.previous_residual = samples[consumed:]
        wav = samples[: consumed + self.window_size - self.window_shift]
        feats = fbank_batch(torch.from_numpy(wav * (2 ** 15))[None],
                            self.sample_rate, self.n_mels)[0].numpy()
        if self.global_cmvn is not None:
            mean, std = self.global_cmvn
            feats = ((feats - mean) / std).astype(np.float32)
        return feats
