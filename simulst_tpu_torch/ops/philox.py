"""Counter-based dropout masks: Philox4x32-10 keyed by (seed, element offset).

Counterpart of the on-core PRNG the JAX package's Pallas kernels draw their
dropout bits from (pltpu.prng_random_bits), which is neither reproducible
off the TPU nor the same between the forward and a separate backward
kernel on the card.  Here every dropout site of a kernel call draws, for
the element at flat offset i, the first word of

    Philox4x32-10(counter = (i mod 2^32, i div 2^32, stream, 0),
                  key = (seed mod 2^32, seed div 2^32))

and keeps the element when that word is below round(keep * 2^32), the
JAX kernels' threshold.  The CUDA kernels compute it in registers
(csrc/common.cuh philox_bits); `philox_bits` below computes the same bits
in torch with int64 arithmetic, so a kernel and its plain version drop
exactly the same elements, and a backward regenerates its forward's mask
from (seed, offset) alone.  `stream` separates two sites of one call (the
FFN's hidden and output dropout).
"""
from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57      # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85      # Weyl key increments
_MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    """P(bits < threshold) == 1 - rate, up to 2^-32 (ffn_pallas
    _keep_threshold)."""
    return min(int(round((1.0 - rate) * 2.0 ** 32)), 2 ** 32 - 1)


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and int64 x
    holding 32-bit values; split in 16-bit halves so no product leaves
    int64."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox_bits(seed: int, offsets: torch.Tensor, stream: int = 0):
    """The 32-bit draw (as int64) of every element offset in `offsets`."""
    offsets = offsets.to(torch.int64)
    c0, c1 = offsets & _MASK32, offsets >> 32
    c2 = torch.full_like(offsets, stream)
    c3 = torch.zeros_like(offsets)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0


def keep_mask(seed: int, shape, rate: float, stream: int = 0,
              device=None) -> torch.Tensor:
    """Bool keep-mask of a tensor of `shape`, element offsets in row-major
    order."""
    n = 1
    for s in shape:
        n *= s
    offsets = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return philox_bits(seed, offsets, stream) < keep_threshold(rate)


def drop_scale(seed: int, shape, rate: float, stream: int = 0,
               device=None) -> torch.Tensor:
    """fp32 multiplier of a dropout site: 1 / keep where kept, 0 where
    dropped."""
    keep = keep_mask(seed, shape, rate, stream, device)
    return torch.where(keep, torch.tensor(1.0 / (1.0 - rate),
                                          dtype=torch.float32, device=device),
                       torch.tensor(0.0, device=device))
