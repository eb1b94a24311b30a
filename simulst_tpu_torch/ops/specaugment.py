"""SpecAugment, policy "lb" (counterpart of simulst_tpu/ops/specaugment.py):
2 frequency masks of width up to 27, 2 time masks of width up to 100 at
p = 1.0, no time warp, masked to 0.

Split into drawing and applying.  `draw_masks` takes its uniform numbers
from a CPU `torch.Generator` in the JAX package's order (width then start,
the frequency masks first) and turns them into per-example (width, start)
pairs on the lengths' device, floor(u * maxval) as the JAX package does;
`apply_masks` masks a (B, T, F) batch with any such pairs, so the applying
half can be held against the JAX function on the same draws.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch


# the "lb" policy
FREQ_MASKS, FREQ_MASK_F = 2, 27
TIME_MASKS, TIME_MASK_T, TIME_MASK_P = 2, 100, 1.0


class Masks(NamedTuple):
    freq: List[Tuple[torch.Tensor, torch.Tensor]]   # (width, start), (B, 1)
    time: List[Tuple[torch.Tensor, torch.Tensor]]


def draw_masks(generator: torch.Generator, lengths, n_feats: int) -> Masks:
    b = lengths.shape[0]
    dev = lengths.device

    def uniform_int(maxval):
        """U[0, maxval) per example (maxval >= 1), (B, 1) int64."""
        u = torch.rand((b, 1), generator=generator).to(dev)
        return torch.floor(u * maxval).long()

    freq, time = [], []
    for _ in range(FREQ_MASKS):
        width = uniform_int(torch.full((b, 1), FREQ_MASK_F + 1.0,
                                       device=dev))
        start = uniform_int(torch.clamp(n_feats - width, min=1).float())
        freq.append((width, start))
    lens = lengths.long()[:, None]
    max_t = torch.clamp((lens.float() * TIME_MASK_P).long(), max=TIME_MASK_T)
    for _ in range(TIME_MASKS):
        width = uniform_int(torch.clamp(max_t, min=0).float() + 1.0)
        start = uniform_int(torch.clamp(lens - width, min=1).float())
        time.append((width, start))
    return Masks(freq=freq, time=time)


def apply_masks(feats, masks: Masks):
    """feats (B, T, F) with every (width, start) band set to 0."""
    b, t, f = feats.shape
    out = feats
    fi = torch.arange(f, device=feats.device)[None, :]
    for width, start in masks.freq:
        band = (fi >= start) & (fi < start + width)               # (B, F)
        out = out.masked_fill(band[:, None, :], 0.0)
    ti = torch.arange(t, device=feats.device)[None, :]
    for width, start in masks.time:
        band = (ti >= start) & (ti < start + width)               # (B, T)
        out = out.masked_fill(band[:, :, None], 0.0)
    return out


def spec_augment(generator: torch.Generator, feats, lengths):
    """feats (B, T, F), lengths (B,) -> masked feats."""
    return apply_masks(feats, draw_masks(generator, lengths, feats.shape[-1]))
