"""CIF criterion: label-smoothed CE + CTC + quantity + DAL latency
(counterpart of simulst_tpu/losses/cif_loss.py).

  * quantity "sum":   clipped MSE of sum(alpha) / beta against the target
    length;
  * quantity "align": the CTC Viterbi best alignment (ops/ctc.best_alignment,
    a host loop over the frames, on the RAW CTC logits as in the JAX
    package) gives each token's last frame; the clipped MSE of
    cumsum(alpha) / beta against the token count at those frames,
    normalised by their number per example;
  * latency: DAL over the CIF delays, clipped at 0;
  * CTC: the unsmoothed nll on raw logits (ops/ctc.ctc_loss_raw: the CTC
    kernels), EOS kept in the targets.
"""
from __future__ import annotations

import dataclasses

import torch

from simulst_tpu_torch.losses.label_smoothed_ce import ce_loss
from simulst_tpu_torch.losses.latency import differentiable_average_lagging
from simulst_tpu_torch.ops.ctc import best_alignment, ctc_loss_raw
from simulst_tpu_torch.ops.monotonic import clip


@dataclasses.dataclass(frozen=True)
class CIFLossConfig:
    label_smoothing: float = 0.1
    ctc_factor: float = 0.3
    quant_factor: float = 1.0
    quant_type: str = "align"          # "sum" | "align"
    quant_clip: float = 10.0
    latency_factor: float = 0.0
    ms_per_frame_shift: float = 10.0
    cif_beta: float = 1.0
    zero_infinity: bool = True
    padding_idx: int = 1
    eos_idx: int = 2
    blank_idx: int = 0
    sentence_avg: bool = False


def _clipped_l2(x, y, clip_value: float):
    """(x - y')^2 with the target y clipped into [x - sqrt(clip), x +
    sqrt(clip)], the clipped target held constant."""
    c = clip_value ** 0.5
    yc = torch.minimum(torch.maximum(y, x - c), x + c).detach()
    return (x - yc) ** 2


def quantity_loss(alpha, ctc_logits, encoder_lengths, target, target_lengths,
                  cfg: CIFLossConfig):
    """(l_quant, quant_acc) for alpha (B, S)."""
    beta = cfg.cif_beta
    b, s = alpha.shape
    if cfg.quant_type == "sum":
        q_out = alpha.sum(dim=1) / beta
        l = _clipped_l2(q_out, target_lengths.float(), cfg.quant_clip).sum()
    elif cfg.quant_type == "align":
        with torch.no_grad():
            states = best_alignment(ctc_logits, encoder_lengths, target,
                                    target_lengths, blank=cfg.blank_idx)
        seg_ids = states // 2
        # the frame after an example's last valid one does not exist: its
        # last emitting frame always closes a segment
        seg_next = torch.cat([seg_ids[:, 1:], seg_ids.new_full((b, 1), -1)],
                             dim=1)
        idx = torch.arange(s, device=alpha.device)[None, :]
        next_invalid = idx + 1 >= encoder_lengths[:, None]
        enc_valid = idx < encoder_lengths[:, None]
        boundary = (((seg_ids != seg_next) | next_invalid)
                    & (states % 2 != 0) & enc_valid)
        q_targets = torch.cumsum(boundary.long(), dim=1).float()
        q_out = torch.cumsum(alpha, dim=1) / beta
        l2 = _clipped_l2(q_out, q_targets, cfg.quant_clip)
        bf = boundary.float()
        norm = bf / clip(bf.sum(dim=1, keepdim=True), 1.0, None)
        l = (l2 * bf * norm).sum()
    else:
        raise NotImplementedError(cfg.quant_type)
    q_acc = ((torch.abs(alpha.sum(1) / beta - target_lengths)
              / torch.clamp(target_lengths, min=1)) <= 0.1).sum()
    return l, q_acc


def cif_loss(logits, extra, target, src_lengths, cfg: CIFLossConfig):
    """(loss, metrics), the metrics detached; logits (B, T, V), extra from
    CIFModel.forward, target (B, T) with EOS."""
    loss, nll = ce_loss(logits, target, cfg.label_smoothing, cfg.padding_idx)

    # EOS stays in the CTC and alignment targets; only PAD is dropped
    keep = target != cfg.padding_idx
    ctc_tgt = torch.where(keep, target, torch.full_like(target,
                                                        cfg.padding_idx))
    ctc_lens = keep.sum(dim=-1)
    enc_lens = extra["encoder_lengths"]
    alpha = extra["alpha"].float()

    c_loss = torch.zeros((), device=logits.device)
    ctc_logits = extra.get("ctc_logits")
    if ctc_logits is not None and cfg.ctc_factor != 0.0:
        c_loss = ctc_loss_raw(ctc_logits, enc_lens, ctc_tgt, ctc_lens,
                              blank=cfg.blank_idx,
                              zero_infinity=cfg.zero_infinity)

    tpm = target == cfg.padding_idx
    tgt_lens = (~tpm).sum(dim=1)
    l_quant, q_acc = quantity_loss(alpha, ctc_logits, enc_lens, ctc_tgt,
                                   ctc_lens, cfg)

    delays = extra["delays"].float()[:, :target.shape[1]]
    el = differentiable_average_lagging(delays, enc_lens, tgt_lens,
                                        target_padding_mask=tpm)
    l_latency = clip(el, 0.0, None).sum()
    latency_ms = (el * (src_lengths / enc_lens * cfg.ms_per_frame_shift)
                  ).sum()

    total = (loss + l_quant * cfg.quant_factor
             + l_latency * cfg.latency_factor + cfg.ctc_factor * c_loss)
    ntokens = (target != cfg.padding_idx).sum()
    nsentences = target.shape[0]
    metrics = {"loss": total.detach(), "nll_loss": nll.detach(),
               "ctc_loss": c_loss.detach(), "quantity": l_quant.detach(),
               "q_acc": q_acc, "latency": latency_ms.detach(),
               "ntokens": ntokens, "nsentences": nsentences,
               "sample_size": nsentences if cfg.sentence_avg else ntokens}
    return total, metrics
