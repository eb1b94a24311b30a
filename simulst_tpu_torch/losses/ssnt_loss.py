"""SSNT criterion (counterpart of simulst_tpu/losses/ssnt_loss.py): the
SSNT loss (ops/ssnt.py) over a log-softmaxed (B, T, U, V) lattice and its
(B, T, U) emit logits.  No model of the package produces emit logits and
no CLI reaches it, in the JAX package either; it is kept for the
reference's inventory."""
from __future__ import annotations

import dataclasses

import torch

from simulst_tpu_torch.ops.ssnt import ssnt_loss as ssnt_nll


@dataclasses.dataclass(frozen=True)
class SSNTLossConfig:
    padding_idx: int = 1
    sentence_avg: bool = False


def ssnt_criterion(lattice_logits, emit_logits, targets, input_lengths,
                   cfg: SSNTLossConfig):
    """lattice_logits: (B, T, U, V); emit_logits: (B, T, U); targets (B,
    U).  Returns (loss, metrics), the metrics detached."""
    lp = torch.log_softmax(lattice_logits.float(), dim=-1)
    tgt_lens = (targets != cfg.padding_idx).sum(dim=1)
    loss = ssnt_nll(lp, emit_logits, targets, input_lengths, tgt_lens)
    ntokens = tgt_lens.sum()
    b = targets.shape[0]
    return loss, {"loss": loss.detach(), "ntokens": ntokens,
                  "nsentences": b,
                  "sample_size": b if cfg.sentence_avg else ntokens}
