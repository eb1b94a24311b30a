"""Continuous Integrate-and-Fire (counterpart of simulst_tpu/ops/cif.py).

The weights alpha (B, S) are distributed over output buckets of width beta
by the closed-form portion product of ops/cif_integrate.py (the CUDA kernel
on the card, on every call: the JAX package's `use_pallas` switch, off by
default there, has no counterpart), then:
  * teacher forcing (target_lengths): alpha is rescaled so that
    sum(alpha) = target_len beta + eps, and the lengths are the targets';
  * otherwise the trailing incomplete bucket (the tail, at index
    floor(sum(alpha) / beta)) is scaled up to weight beta, its delay with
    it, and counts as an output iff its weight exceeds tail_thres;
  * delays[b, k] = sum_j portion[j, k] (j + 1) / beta, the expected
    1-based source frame of each output; outputs and delays past the
    lengths are zeroed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from simulst_tpu_torch.ops.cif_integrate import cif_integrate
from simulst_tpu_torch.ops.monotonic import clip


class CifOut(NamedTuple):
    cif_out: torch.Tensor       # (B, T, C)
    cif_lengths: torch.Tensor   # (B,) int64
    alpha_sum: torch.Tensor     # (B,) fp32
    delays: torch.Tensor        # (B, T) fp32
    tail_weights: torch.Tensor  # (B,) fp32


def cif_function(x, alpha, beta: float = 1.0, tail_thres: float = 0.5,
                 target_lengths: Optional[torch.Tensor] = None,
                 max_out_len: Optional[int] = None,
                 eps: float = 1e-4) -> CifOut:
    """x: (B, S, C); alpha: (B, S) non-negative weights, already zero at
    padding; max_out_len: the number of output buckets T."""
    if max_out_len is None:
        raise ValueError("max_out_len required (static output size)")
    b = x.shape[0]
    t = max_out_len
    alpha = alpha.float()
    alpha_sum = alpha.sum(dim=1)
    if target_lengths is not None:
        desired = target_lengths.float() * beta + eps
        alpha = alpha * (desired / clip(alpha_sum, eps, None))[:, None]
    else:
        fires = torch.floor(alpha_sum / beta).long()

    # the integration runs in fp32 whatever x's dtype, as the JAX package's
    # (its reference and its Pallas call take x as fp32)
    out, delays = cif_integrate(x.float(), alpha, float(beta), t)
    out = out.to(x.dtype)

    if target_lengths is not None:
        lengths = target_lengths.long()
        tail_w = torch.zeros(b, dtype=torch.float32, device=x.device)
    else:
        tail_w = alpha_sum - fires.float() * beta
        scale = beta / clip(tail_w, eps, None)
        is_tail = torch.arange(t, device=x.device)[None, :] == fires[:, None]
        out = torch.where(is_tail[:, :, None],
                          out * scale[:, None, None].to(out.dtype), out)
        has_tail = tail_w > (tail_thres if tail_thres > 0 else 0.0)
        lengths = fires + has_tail.long()
        # the tail's delay keeps the unscaled expectation; past the buffer
        # (fires >= t) no bucket is the tail and the gathered value is unused
        tail_delay = delays.gather(1, torch.clamp(fires, max=t - 1)[:, None])
        tail_delay = tail_delay[:, 0] * beta / clip(tail_w, eps, None)
        delays = torch.where(is_tail, tail_delay[:, None], delays)

    valid = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    out = torch.where(valid[:, :, None], out, torch.zeros_like(out))
    delays = torch.where(valid, delays, torch.zeros_like(delays))
    return CifOut(cif_out=out, cif_lengths=lengths, alpha_sum=alpha_sum,
                  delays=delays, tail_weights=tail_w)
