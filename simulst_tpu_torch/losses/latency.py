"""Latency metrics: AL / AP / DAL, and DAL for training (counterpart of
simulst_tpu/losses/latency.py; SimulEval's definitions).

  gamma = tgt_len / src_len
  AL    = (1 / tau) sum_{i <= tau} (d_i - i / gamma), tau the first i with
          d_i >= src_len (else tgt_len - 1), i 0-based
  AP    = sum_i d_i / (src_len tgt_len)
  DAL   = (1 / T) sum_i (g_i - i / gamma), g_i = max(d_i, g_{i-1} + 1 / gamma)

DAL's recurrence has the closed form g_i - i / gamma = cummax_{k <= i}
(d_k - k / gamma), one torch.cummax along the target axis.  At a tie
torch.cummax routes the whole gradient to one of the tied entries (the
JAX package's associative max scan splits it); wait-k's integer delays
tie, but there the delays carry no gradient.
"""
from __future__ import annotations

import torch


def _prep(delays, src_lens, tgt_lens, target_padding_mask):
    delays = delays.float()
    if target_padding_mask is not None:
        delays = delays.masked_fill(target_padding_mask, 0.0)
    gamma = tgt_lens.float() / src_lens.float()
    return delays, gamma


def differentiable_average_lagging(delays, src_lens, tgt_lens,
                                   target_padding_mask=None):
    """(B, T) delays -> (B,) DAL in source-step units."""
    delays, gamma = _prep(delays, src_lens, tgt_lens, target_padding_mask)
    idx = torch.arange(delays.shape[1], dtype=torch.float32,
                       device=delays.device)[None, :]
    shifted = delays - idx / gamma[:, None]
    if target_padding_mask is not None:
        # padded positions must not win the cummax
        shifted = shifted.masked_fill(target_padding_mask, float("-inf"))
    lag = torch.cummax(shifted, dim=1).values           # g_i - i / gamma
    if target_padding_mask is not None:
        lag = lag.masked_fill(target_padding_mask, 0.0)
    return lag.sum(dim=1) / torch.clamp(tgt_lens.float(), min=1.0)


def average_lagging(delays, src_lens, tgt_lens, target_padding_mask=None):
    delays, gamma = _prep(delays, src_lens, tgt_lens, target_padding_mask)
    idx = torch.arange(delays.shape[1], dtype=torch.float32,
                       device=delays.device)[None, :]
    valid = (idx < tgt_lens[:, None]) if target_padding_mask is None \
        else ~target_padding_mask
    reached = (delays >= src_lens[:, None].float()) & valid
    first = reached.int().argmax(dim=1)                 # first True
    tau = torch.where(reached.any(dim=1), first, tgt_lens - 1)
    lag = delays - idx / gamma[:, None]
    in_range = (idx <= tau[:, None]) & valid
    return (torch.where(in_range, lag, torch.zeros_like(lag)).sum(dim=1)
            / torch.clamp(tau + 1, min=1).float())


def average_proportion(delays, src_lens, tgt_lens, target_padding_mask=None):
    delays, _ = _prep(delays, src_lens, tgt_lens, target_padding_mask)
    return delays.sum(dim=1) / (src_lens * tgt_lens).float()


LATENCY_METRICS = {
    "average_lagging": average_lagging,
    "average_proportion": average_proportion,
    "differentiable_average_lagging": differentiable_average_lagging,
}
