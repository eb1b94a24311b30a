"""RNN-T (transducer) loss in plain torch (counterpart of
simulst_tpu/ops/rnnt.py, which has no kernel either).

The alpha lattice recursion
    alpha(t, u) = logadd(alpha(t-1, u) + blank(t-1, u),
                         alpha(t, u-1) + emit(t, u-1))
runs over the anti-diagonals d = t + u: both dependencies of diagonal d lie
on diagonal d - 1, so each of the T + U - 1 steps is one (B, U+1) update.
The blank and emit grids are skewed once into (T + U, B, U+1) tensors whose
slice d holds diagonal d (the emit grid also shifted by one label, so that
slice d - 1 lines up with alpha(t, u-1)), and the validity of every cell is
one precomputed mask: a step is an add, a shifted add, a logaddexp and a
select, and autograd runs the loop backwards.  That is 5 ops a step forward
(the shift is a pad), about 10 backward.

FastEmit (Yu et al., 2021) scales the emission log-probs' gradient by
(1 + lambda) with the value-preserving x * (1 + l) - x.detach() * l.

A row without source frames (input length 0: the speech batcher pads a
batch to its multiple with empty utterances) has no alignment and adds 0.
The JAX package reads such a row at diagonal U - 1 and frame -1, which
adds about 1e30 to the loss (ROADMAP Queue 3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def skew(grid, fill: float):
    """grid (B, T, U+1) -> (T + U, B, U+1) with [d, b, u] = grid[b, d - u,
    u] where 0 <= d - u < T, else `fill`."""
    b, t, u1 = grid.shape
    d = torch.arange(t + u1 - 1, device=grid.device)[:, None]
    tt = d - torch.arange(u1, device=grid.device)[None, :]       # (D, U+1)
    idx = tt.clamp(0, t - 1)[None].expand(b, -1, -1)              # (B, D, U+1)
    vals = torch.where((tt >= 0) & (tt < t), grid.gather(1, idx),
                       torch.full((), fill, dtype=grid.dtype,
                                  device=grid.device))
    return vals.transpose(0, 1).contiguous()


def diagonal_valid(t: int, u1: int, target_lengths):
    """(T + U, B, U+1) bool: the cells (d - u, u) inside the lattice with u
    within each example's target length."""
    d = torch.arange(t + u1 - 1, device=target_lengths.device)[:, None]
    us = torch.arange(u1, device=target_lengths.device)
    tt = d - us[None, :]
    inside = (tt >= 0) & (tt < t)
    return inside[:, None, :] & (us[None, None, :]
                                 <= target_lengths[None, :, None])


def diagonal_scan(stay, move, valid, n_steps: int):
    """alpha over diagonals 0..n_steps: alpha_0 = [0, NEG, ...], then
    alpha_d = where(valid[d], logaddexp(alpha + stay[d-1], shift(alpha) +
    move[d-1]), NEG), shift(a)[u] = a[u-1] (NEG at u = 0), `move` already
    shifted.  Returns the (n_steps + 1, B, U+1) stack of diagonals."""
    b, u1 = stay.shape[1:]
    alpha = torch.full((b, u1), NEG, dtype=stay.dtype, device=stay.device)
    alpha[:, 0] = 0.0
    neg = torch.full((), NEG, dtype=stay.dtype, device=stay.device)
    diags = [alpha]
    for d in range(1, n_steps + 1):
        new = torch.logaddexp(alpha + stay[d - 1],
                              F.pad(alpha[:, :-1], (1, 0), value=NEG)
                              + move[d - 1])
        alpha = torch.where(valid[d], new, neg)
        diags.append(alpha)
    return torch.stack(diags)


def shift_labels(grid, fill: float):
    """(D, B, U+1) -> the same with [.., u] = grid[.., u-1], `fill` at 0."""
    return F.pad(grid[:, :, :-1], (1, 0), value=fill)


def rnnt_loss(log_probs, targets, input_lengths, target_lengths,
              blank: int = 0, fastemit_lambda: float = 0.0):
    """log_probs: (B, T, U+1, V) log-softmaxed joiner lattice; targets: (B,
    U) right-padded.  Returns the batch-summed NLL."""
    b, t, u1, v = log_probs.shape
    u = u1 - 1
    lp = log_probs.float()
    lp_blank = lp[..., blank]                                    # (B, T, U+1)
    lp_emit = lp[:, :, :u].gather(
        -1, targets.long()[:, None, :, None].expand(b, t, u, 1))[..., 0]
    if fastemit_lambda > 0.0:
        lp_emit = (lp_emit * (1.0 + fastemit_lambda)
                   - lp_emit.detach() * fastemit_lambda)
    lp_emit = F.pad(lp_emit, (0, 1), value=NEG)                  # (B, T, U+1)

    target_lengths = target_lengths.long()
    input_lengths = input_lengths.long()
    diags = diagonal_scan(skew(lp_blank, NEG),
                          shift_labels(skew(lp_emit, NEG), NEG),
                          diagonal_valid(t, u1, target_lengths), t + u - 1)
    # the final alpha(t_b - 1, u_b) sits on diagonal t_b - 1 + u_b at u_b
    rows = torch.arange(b, device=lp.device)
    a_final = diags[input_lengths - 1 + target_lengths, rows, target_lengths]
    lb_final = lp_blank[rows, input_lengths - 1, target_lengths]
    return -torch.where(input_lengths > 0, a_final + lb_final, 0.0).sum()
