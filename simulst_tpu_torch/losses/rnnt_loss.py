"""Transducer criterion: the RNN-T loss with FastEmit plus the offline
path's label-smoothed CE (counterpart of simulst_tpu/losses/rnnt_loss.py).

The RNN-T term runs over the log-softmaxed (B, S, U+1, V) joiner lattice
(ops/rnnt.py); the offline path is a label-smoothed CE on the lattice
column at each example's last source frame, which trains the column that
offline decoding reads.
"""
from __future__ import annotations

import dataclasses

import torch

from simulst_tpu_torch.losses.label_smoothed_ce import label_smoothed_nll_loss
from simulst_tpu_torch.ops.rnnt import rnnt_loss as rnnt_nll


@dataclasses.dataclass(frozen=True)
class RNNTLossConfig:
    label_smoothing: float = 0.1
    fastemit_lambda: float = 0.0
    offline_factor: float = 1.0
    padding_idx: int = 1
    blank_idx: int = 0
    sentence_avg: bool = False


def rnnt_criterion(lattice_logits, extra, cfg: RNNTLossConfig):
    """lattice_logits: (B, S, U+1, V); extra: from TransducerModel.forward
    (label_tokens (B, U+1) = [bos, y.., eos, pad..], label_lengths,
    encoder_lengths).  Returns (loss, metrics), the metrics detached."""
    b, s, u1, v = lattice_logits.shape
    lp = torch.log_softmax(lattice_logits.float(), dim=-1)
    # the tokens to emit: the labels without the leading bos (eos included)
    targets = extra["label_tokens"][:, 1:]
    enc_lens = extra["encoder_lengths"]
    loss_rnnt = rnnt_nll(lp, targets, enc_lens, extra["label_lengths"] - 1,
                         blank=cfg.blank_idx,
                         fastemit_lambda=cfg.fastemit_lambda)

    # offline path: predict token u at state u from the last source frame
    last = torch.clamp(enc_lens.long() - 1, 0, s - 1)
    col = lp[torch.arange(b, device=lp.device), last]             # (B, U+1, V)
    ce_target = torch.nn.functional.pad(targets, (0, 1),
                                        value=cfg.padding_idx)[:, :u1]
    off_loss, off_nll = label_smoothed_nll_loss(
        col, ce_target, cfg.label_smoothing, cfg.padding_idx)

    loss = loss_rnnt + cfg.offline_factor * off_loss
    ntokens = (ce_target != cfg.padding_idx).sum()
    return loss, {"loss": loss.detach(), "rnnt_loss": loss_rnnt.detach(),
                  "nll_loss": off_nll.detach(), "ntokens": ntokens,
                  "nsentences": b,
                  "sample_size": b if cfg.sentence_avg else ntokens}
