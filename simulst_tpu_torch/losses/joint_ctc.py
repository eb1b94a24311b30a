"""Joint label-smoothed CE + CTC criterion (counterpart of
simulst_tpu/losses/joint_ctc.py).

  loss = LS-CE(decoder logits) + ctc_factor * LS-CTC(encoder ctc logits)

where the CTC term is itself label-smoothed as
(1 - eps) * ctc_nll + (eps / V) * sum_t -sum_v lprobs[t, v] over valid
encoder frames (eps / V, not eps / (V - 1), as the reference criterion).
CTC targets drop PAD and EOS.  Sum reduction: the train step divides the
gradients by the summed sample size.
"""
from __future__ import annotations

import dataclasses

import torch

from simulst_tpu_torch.losses.label_smoothed_ce import ce_loss
from simulst_tpu_torch.ops.ctc import ctc_raw_smoothed


@dataclasses.dataclass(frozen=True)
class JointCTCConfig:
    label_smoothing: float = 0.1
    ctc_factor: float = 1.0
    zero_infinity: bool = True
    padding_idx: int = 1
    eos_idx: int = 2
    blank_idx: int = 0
    sentence_avg: bool = False


def ctc_targets(target, cfg: JointCTCConfig):
    """EOS and PAD become PAD; lengths count the rest (EOS is always last,
    so the kept tokens stay a prefix)."""
    keep = (target != cfg.padding_idx) & (target != cfg.eos_idx)
    return (torch.where(keep, target, torch.full_like(target,
                                                      cfg.padding_idx)),
            keep.sum(dim=-1))


def smoothed_ctc_loss(ctc_logits, encoder_lengths, target,
                      cfg: JointCTCConfig):
    """(label-smoothed CTC sum, CTC nll sum) from RAW ctc logits: the
    smoothing term -sum_v lprobs[t, v] equals V LSE(logits[t]) -
    sum_v logits[t, v], which ctc_raw_smoothed sums alongside the nll."""
    tgt, tgt_lens = ctc_targets(target, cfg)
    nll, smooth = ctc_raw_smoothed(ctc_logits, encoder_lengths, tgt,
                                   tgt_lens, cfg.blank_idx,
                                   cfg.zero_infinity, True)
    eps_i = cfg.label_smoothing / ctc_logits.shape[-1]
    return (1.0 - cfg.label_smoothing) * nll + eps_i * smooth, nll


def _bincount_rows(tokens, vocab_size: int):
    counts = torch.zeros(tokens.shape[0], vocab_size, device=tokens.device)
    return counts.scatter_add_(1, tokens.long(),
                               torch.ones_like(tokens, dtype=counts.dtype))


def ctc_greedy_recall_precision(pred, target, vocab_size: int,
                                cfg: JointCTCConfig, eps: float = 1e-8):
    """Bag-of-tokens recall and precision of the per-frame greedy CTC path
    (no collapse), summed over the batch: match = sum_v min(count_v(target),
    count_v(pred)); recall = match / non-pad target tokens; precision =
    match / non-blank predicted frames."""
    match = torch.minimum(_bincount_rows(pred, vocab_size),
                          _bincount_rows(target, vocab_size)).sum(-1)
    recall = match / ((target != cfg.padding_idx).sum(-1) + eps)
    precision = match / ((pred != cfg.blank_idx).sum(-1) + eps)
    return recall.sum(), precision.sum()


def joint_ctc_loss(logits, extra, target, cfg: JointCTCConfig,
                   ctc_target=None):
    """logits: (B, T, V) decoder output; extra: dict with ctc_logits (or
    None) and encoder_lengths; target: (B, T) with EOS, right-padded;
    ctc_target: separate CTC targets (transcripts, for --mtl) or None.
    Returns (loss, metrics), the metrics detached."""
    loss, nll = ce_loss(logits, target, cfg.label_smoothing, cfg.padding_idx)
    metrics = {"nll_loss": nll.detach()}
    ctc_logits = extra.get("ctc_logits")
    if ctc_logits is not None and cfg.ctc_factor != 0.0:
        tgt = target if ctc_target is None else ctc_target
        closs, _ = smoothed_ctc_loss(ctc_logits, extra["encoder_lengths"],
                                     tgt, cfg)
        loss = loss + cfg.ctc_factor * closs
        metrics["ctc_loss"] = closs.detach()
        with torch.no_grad():
            pred = ctc_logits.argmax(-1)
            metrics["blank_rate"] = (pred == cfg.blank_idx).float().mean(
                -1).sum()
            metrics["ctc_recall"], metrics["ctc_precision"] = \
                ctc_greedy_recall_precision(pred, tgt, ctc_logits.shape[-1],
                                            cfg)
    ntokens = (target != cfg.padding_idx).sum()
    nsentences = target.shape[0]
    metrics.update(loss=loss.detach(), ntokens=ntokens,
                   nsentences=nsentences,
                   sample_size=nsentences if cfg.sentence_avg else ntokens)
    return loss, metrics
