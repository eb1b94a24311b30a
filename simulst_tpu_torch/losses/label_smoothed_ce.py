"""Label-smoothed cross entropy, fairseq semantics (counterpart of
simulst_tpu/losses/label_smoothed_ce.py).

The smoothing mass is spread over ALL vocab entries (eps_i = eps / (V - 1)
on the sum of -lprobs), padding targets are excluded, and the reduction is
a sum, so the train step divides the gradients by the summed sample size.
"""
from __future__ import annotations

import torch


def label_smoothed_nll_loss(lprobs, target, epsilon: float,
                            ignore_index: int):
    """lprobs: (..., V) log-probs; target: (...) int.
    Returns (loss_sum, nll_loss_sum) as fp32 scalars."""
    lprobs = lprobs.float()
    nll = -lprobs.gather(-1, target[..., None].long())[..., 0]
    smooth = -lprobs.sum(dim=-1)
    mask = target != ignore_index
    nll = torch.where(mask, nll, 0.0)
    smooth = torch.where(mask, smooth, 0.0)
    eps_i = epsilon / (lprobs.shape[-1] - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return loss.sum(), nll.sum()


def log_softmax(logits):
    return torch.log_softmax(logits.float(), dim=-1)


def ce_loss(logits, target, label_smoothing: float, padding_idx: int):
    """(B, T, V) logits, (B, T) target."""
    return label_smoothed_nll_loss(log_softmax(logits), target,
                                   label_smoothing, padding_idx)
