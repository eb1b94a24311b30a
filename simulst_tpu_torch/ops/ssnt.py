"""SSNT (segment-to-segment neural transduction) loss in plain torch
(counterpart of simulst_tpu/ops/ssnt.py).

SSNT marginalises over monotonic alignments where at each (t, u) the model
either EMITS token u (probability e_{t,u} p(y_u | t, u)) or SHIFTS to the
next source frame (probability 1 - e):

    alpha(t, u) = logadd(alpha(t-1, u) + log(1-e)(t-1, u),
                         alpha(t, u-1) + log e(t, u-1) + lp(t, u-1, y_{u-1}))

over anti-diagonals, as the RNN-T loss (ops/rnnt.py, whose skewed grids and
diagonal loop it shares).  The loss is -alpha(T-1, U): the last token must
be emitted by the last frame, and shifting in the terminal state u = U
costs nothing; a row without source frames adds 0, as in the RNN-T loss.
No model of the package produces the emit logits, in the JAX package
either; `losses/ssnt_loss.py` wraps it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from simulst_tpu_torch.ops.rnnt import (NEG, diagonal_scan, diagonal_valid,
                                        shift_labels, skew)


def ssnt_loss(log_probs, emit_logits, targets, input_lengths,
              target_lengths):
    """log_probs: (B, T, U, V) token log-probs; emit_logits: (B, T, U)
    logits of the emit probability; targets: (B, U).  Returns the
    batch-summed NLL."""
    b, t, u, v = log_probs.shape
    lp = log_probs.float()
    emit = F.logsigmoid(emit_logits.float())                      # log e
    stay = F.logsigmoid(-emit_logits.float())                     # log(1-e)
    tok = lp.gather(-1, targets.long()[:, None, :, None].expand(
        b, t, u, 1))[..., 0]                                       # (B, T, U)
    emit_p = F.pad(emit + tok, (0, 1), value=NEG)               # (B, T, U+1)
    stay_p = F.pad(stay, (0, 1), value=0.0)

    target_lengths = target_lengths.long()
    input_lengths = input_lengths.long()
    diags = diagonal_scan(skew(stay_p, 0.0),
                          shift_labels(skew(emit_p, NEG), NEG),
                          diagonal_valid(t, u + 1, target_lengths),
                          t + u - 1)
    rows = torch.arange(b, device=lp.device)
    a_final = diags[input_lengths - 1 + target_lengths, rows, target_lengths]
    return -torch.where(input_lengths > 0, a_final, 0.0).sum()


def ssnt_loss_mem(log_probs, emit_logits, targets, input_lengths,
                  target_lengths):
    """The upstream package's memory-lean entry: here the same loop, which
    already keeps O(B U) per step."""
    return ssnt_loss(log_probs, emit_logits, targets, input_lengths,
                     target_lengths)
