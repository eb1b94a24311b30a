"""MMA criterion: label-smoothed CE + the latency loss (counterpart of
simulst_tpu/losses/mma_loss.py).

Expected delays sum_j (j + 1) alpha_ij per layer and head; the latency
metric (default DAL) per head, gathered across the layers' heads by
weighted_average / average / max; plus a variance-across-heads term.
With latency_update_after > 0 the latency term stays off while
num_updates <= latency_update_after; the training CLI, like the JAX
package's, calls mma_loss without num_updates, so there it never turns on.
"""
from __future__ import annotations

import dataclasses

import torch

from simulst_tpu_torch.losses.label_smoothed_ce import ce_loss
from simulst_tpu_torch.losses.latency import LATENCY_METRICS
from simulst_tpu_torch.ops.monotonic import clip


@dataclasses.dataclass(frozen=True)
class MMALossConfig:
    label_smoothing: float = 0.1
    latency_avg_weight: float = 0.0
    latency_var_weight: float = 0.0
    latency_avg_type: str = "differentiable_average_lagging"
    latency_gather_method: str = "weighted_average"
    latency_update_after: int = 0
    ms_per_frame_shift: float = 10.0
    padding_idx: int = 1
    sentence_avg: bool = False


def mma_latency_loss(attn_list, target, src_lengths, encoder_lengths,
                     cfg: MMALossConfig):
    """attn_list: per layer a dict with alpha (B, H, T, S).  Returns
    (latency_loss, expected_latency_ms_sum, delays_var_sum)."""
    alpha_all = torch.cat([a["alpha"] for a in attn_list], dim=1)
    b, lh, t, s = alpha_all.shape
    alpha_flat = alpha_all.reshape(b * lh, t, s).float()

    steps = torch.arange(1, s + 1, dtype=torch.float32,
                         device=alpha_flat.device)
    expected_delays = alpha_flat @ steps                          # (B LH, T)

    tpm = target == cfg.padding_idx                               # (B, T)
    tgt_lens = (~tpm).sum(dim=1)

    def ex(v):
        return v.repeat_interleave(lh, dim=0)

    latency = LATENCY_METRICS[cfg.latency_avg_type](
        expected_delays, ex(encoder_lengths), ex(tgt_lens),
        target_padding_mask=ex(tpm)).reshape(b, lh)

    if cfg.latency_gather_method == "average":
        gathered = latency.mean(dim=1)
    elif cfg.latency_gather_method == "weighted_average":
        w = torch.softmax(latency, dim=1)
        gathered = (latency * w).sum(dim=1)
    elif cfg.latency_gather_method == "max":
        gathered = latency.amax(dim=1)
    else:
        raise NotImplementedError(cfg.latency_gather_method)

    avg_loss = cfg.latency_avg_weight * clip(gathered, 0.0, None).sum()
    delays_var = expected_delays.reshape(b, lh, t).var(
        dim=1, correction=0).mean(dim=1).sum()
    var_loss = cfg.latency_var_weight * delays_var
    latency_ms = (gathered * (src_lengths / encoder_lengths
                              * cfg.ms_per_frame_shift)).sum()
    return avg_loss + var_loss, latency_ms, delays_var


def mma_loss(logits, extra, target, src_lengths, cfg: MMALossConfig,
             num_updates: int = 0):
    """(loss, metrics), the metrics detached; extra holds attn_list and
    encoder_lengths (MMAModel.forward)."""
    loss, nll = ce_loss(logits, target, cfg.label_smoothing, cfg.padding_idx)
    lat_loss, latency_ms, delays_var = mma_latency_loss(
        extra["attn_list"], target, src_lengths, extra["encoder_lengths"], cfg)
    if cfg.latency_update_after > 0 and \
            num_updates <= cfg.latency_update_after:
        lat_loss = torch.zeros_like(lat_loss)
    loss = loss + lat_loss
    ntokens = (target != cfg.padding_idx).sum()
    nsentences = target.shape[0]
    metrics = {"loss": loss.detach(), "nll_loss": nll.detach(),
               "latency": latency_ms.detach(),
               "delays_var": delays_var.detach(),
               "latency_loss": lat_loss.detach(), "ntokens": ntokens,
               "nsentences": nsentences,
               "sample_size": nsentences if cfg.sentence_avg else ntokens}
    return loss, metrics
