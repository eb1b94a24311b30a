"""Monotonic attention math: expected alignment, soft attention, p_choose
(counterpart of simulst_tpu/ops/monotonic.py).

The target-axis recursion of the expected alignment is
`_alignment_recursion`, a torch.autograd.Function whose forward and
backward are the alignment kernels of ops/monotonic_align.py (CUDA on the
card, their plain loops on the CPU); the cumprod preparation around it
stays plain, differentiable torch.  Clips that autograd differentiates
are written min(max(x, lo), hi): at an exact tie torch.maximum /
torch.minimum split the gradient in halves as jnp.clip does (torch.clamp
would pass all of it).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from simulst_tpu_torch.ops import _build
from simulst_tpu_torch.ops.monotonic_align import alignment_bwd, alignment_fwd


def clip(x, lo: Optional[float], hi: Optional[float]):
    """jnp.clip with jnp's gradient at ties."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def exclusive_cumprod(x, dim: int, eps: float = 1e-10):
    """[1, x1, x1 x2, ...] via exp(cumsum(log(. + eps)))."""
    ones_shape = list(x.shape)
    ones_shape[dim] = 1
    padded = torch.cat([x.new_ones(ones_shape), x], dim=dim)
    cp = torch.exp(torch.cumsum(torch.log(padded + eps), dim=dim))
    return cp.narrow(dim, 0, x.shape[dim])


def moving_sum(x, start: int, end: int):
    """Windowed sum over the last axis of x (B, Tq, S): position n sums
    [n - (start - 1), n + end - 1]."""
    b, tq, s = x.shape
    ksz = start + end - 1
    xp = F.pad(x.reshape(-1, s), (start - 1, end - 1))
    cs = torch.cumsum(F.pad(xp, (1, 0)), dim=1)
    out = cs[:, ksz:] - cs[:, :-ksz]
    return out.reshape(b, tq, s)


class _AlignmentRecursion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prefix, denom):
        alphas = alignment_fwd(prefix, denom)
        ctx.save_for_backward(prefix, denom, alphas)
        return alphas

    @staticmethod
    def backward(ctx, g):
        prefix, denom, alphas = ctx.saved_tensors
        return alignment_bwd(prefix, denom, alphas, g.float().contiguous())


def _alignment_recursion(prefix, denom):
    """alphas (N, U, S) from alpha_u = clip(prefix_u * cumsum(alpha_{u-1} /
    denom_u), 0, 1); differentiable in prefix and denom through the
    hand-derived reverse recursion."""
    prefix, denom = prefix.float().contiguous(), denom.float().contiguous()
    if not _build.needs_grad(prefix, denom):
        return alignment_fwd(prefix, denom)
    return _AlignmentRecursion.apply(prefix, denom)


def expected_alignment_from_p_choose(p_choose, key_padding_mask=None,
                                     eps: float = 1e-6):
    """alpha_i = p_i * cumprod(1 - p_i) * cumsum(alpha_{i-1} /
    cumprod(1 - p_i)).  p_choose: (B, T_tgt, S_src) in [0, 1]; returns fp32
    alpha of the same shape."""
    p = p_choose.float()
    if key_padding_mask is not None:
        p = p.masked_fill(key_padding_mask[:, None, :], 0.0)
    cumprod_1mp = exclusive_cumprod(1 - p, dim=2, eps=eps)
    cumprod_clamp = clip(cumprod_1mp, eps, 1.0)
    prefix = p * cumprod_1mp
    return _alignment_recursion(prefix, cumprod_clamp)


def mass_preservation(alpha, key_padding_mask=None):
    """Move the residual probability mass onto the last VALID source
    position (right padding)."""
    if key_padding_mask is not None:
        alpha = alpha.masked_fill(key_padding_mask[:, None, :], 0.0)
        src_lens = (~key_padding_mask).sum(dim=1)
    else:
        src_lens = torch.full((alpha.shape[0],), alpha.shape[-1],
                              device=alpha.device)
    residual = 1.0 - clip(alpha.sum(dim=-1, keepdim=True), 0.0, 1.0)
    last = (src_lens - 1)[:, None, None]
    cols = torch.arange(alpha.shape[-1], device=alpha.device)
    onehot = cols[None, None, :] == last
    return alpha + residual * onehot


def expected_soft_attention(alpha, soft_energy, key_padding_mask=None,
                            chunk_size: Optional[int] = None,
                            eps: float = 1e-10, neg_inf: float = -1e8):
    """MoChA / MILk beta from alpha and the soft energy (chunk_size: the
    MoChA window, None for infinite lookback)."""
    if key_padding_mask is not None:
        alpha = alpha.masked_fill(key_padding_mask[:, None, :], 0.0)
        soft_energy = soft_energy.masked_fill(key_padding_mask[:, None, :],
                                              neg_inf)
    alpha = alpha.float()
    soft_energy = soft_energy.float()
    soft_energy = soft_energy - soft_energy.amax(dim=2, keepdim=True)
    exp_e = torch.exp(soft_energy) + eps
    if chunk_size is not None:
        beta = exp_e * moving_sum(
            alpha / (eps + moving_sum(exp_e, chunk_size, 1)), 1, chunk_size)
    else:
        inner = alpha / (eps + torch.cumsum(exp_e, dim=2))
        beta = exp_e * torch.flip(torch.cumsum(torch.flip(inner, [2]), dim=2),
                                  [2])
    if key_padding_mask is not None:
        beta = beta.masked_fill(key_padding_mask[:, None, :], 0.0)
    return clip(beta, 0.0, 1.0)


# ---------------------------------------------------------------------------
# p_choose strategies
# ---------------------------------------------------------------------------

def waitk_p_choose(tgt_len: int, src_len: int, bsz: int, waitk_lagging: int,
                   key_padding_mask=None, online: bool = False, device=None):
    """Deterministic one-hot diagonal p_choose, (B, tgt_len, src_len) float
    0 / 1, on key_padding_mask's device (else `device`)."""
    if key_padding_mask is not None:
        device = key_padding_mask.device
        key_eos = (~key_padding_mask).sum(-1) - 1
    else:
        key_eos = torch.full((bsz,), src_len - 1, device=device)
    steps = torch.arange(tgt_len, device=device) + (waitk_lagging - 1)
    steps = steps[None, :].expand(bsz, tgt_len)
    if not online:
        steps = torch.minimum(steps, key_eos[:, None])
    return (torch.arange(src_len, device=device)[None, None, :]
            == steps[:, :, None]).float()


def learnable_p_choose(energy, noise_mean: float = 0.0,
                       noise_std: float = 1.0,
                       generator: Optional[torch.Generator] = None):
    """sigmoid(energy + N(mean, std) noise); the noise is drawn from
    `generator` (on energy's device) when one is given, as in training."""
    if generator is None:
        return torch.sigmoid(energy)
    noise = torch.randn(energy.shape, generator=generator,
                        device=energy.device, dtype=energy.dtype)
    return torch.sigmoid(energy + (noise * noise_std + noise_mean))
