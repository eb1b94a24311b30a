"""The MMA expected-alignment recursion, forward and backward (counterpart
of simulst_tpu/ops/monotonic_pallas.py `alignment_fwd_pallas` and
`alignment_bwd_pallas`).

Over (N, U, S) fp32 panels, N = B H rows, sequential in u:

    alpha_u = min(max(prefix_u * cumsum(alpha_{u-1} / denom_u), 0), 1)

with alpha_{-1} one-hot at s = 0, and its hand-derived reverse recursion
(the JAX package's `_step_bwd`): the gate is a hard zero at both clip
boundaries.  `alignment_fwd` and `alignment_bwd` run the CUDA kernels of
csrc/monotonic.cu on a CUDA tensor (one warp per row up to S 128, a
block of ceil(S / 32) warps up to 256, any U >= 1 and S >= 1) and their
plain versions `alignment_fwd_plain` / `alignment_bwd_plain`, loops over U
in the same formulas, on a CPU tensor.
"""
from __future__ import annotations

import torch

from simulst_tpu_torch.ops import _build


def _alpha0(n: int, s: int, device) -> torch.Tensor:
    a = torch.zeros(n, s, dtype=torch.float32, device=device)
    a[:, 0] = 1.0
    return a


def alignment_fwd_plain(prefix, denom):
    """(N, U, S) alphas: divide, cumsum, multiply by prefix, clip."""
    n, u, s = prefix.shape
    a = _alpha0(n, s, prefix.device)
    out = torch.empty_like(prefix)
    for i in range(u):
        c = torch.cumsum(a / denom[:, i], dim=-1)
        a = torch.clamp(prefix[:, i] * c, 0.0, 1.0)
        out[:, i] = a
    return out


def alignment_bwd_plain(prefix, denom, alphas, g):
    """(d_prefix, d_denom), each (N, U, S), for upstream gradient g."""
    n, u, s = prefix.shape
    carry = torch.zeros(n, s, dtype=torch.float32, device=prefix.device)
    d_prefix, d_denom = torch.empty_like(prefix), torch.empty_like(prefix)
    for i in range(u - 1, -1, -1):
        prev = _alpha0(n, s, prefix.device) if i == 0 else alphas[:, i - 1]
        gu = g[:, i] + carry
        c = torch.cumsum(prev / denom[:, i], dim=-1)
        pre = prefix[:, i] * c
        gu = torch.where((pre > 0.0) & (pre < 1.0), gu, torch.zeros_like(gu))
        d_prefix[:, i] = gu * c
        r = torch.flip(torch.cumsum(torch.flip(gu * prefix[:, i], [-1]), -1),
                       [-1])
        d_denom[:, i] = -(r * prev) / (denom[:, i] * denom[:, i])
        carry = r / denom[:, i]
    return d_prefix, d_denom


def _kernel_args(name, *tensors):
    """The tensors as contiguous fp32 (N, U, S) CUDA tensors of one shape,
    or raise."""
    ref = tensors[0]
    if ref.ndim != 3 or min(ref.shape) < 1 or \
            any(t.shape != ref.shape for t in tensors):
        raise ValueError(f"{name}: kernel takes (N, U, S) panels of one shape "
                         f"with N, U, S >= 1; got "
                         f"{[tuple(t.shape) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{name}: kernel takes float32, got "
                        f"{[t.dtype for t in tensors]}")
    out = [t.contiguous() for t in tensors]
    _build.check_cuda(name, out[0], **{f"input{i}": t
                                       for i, t in enumerate(out[1:])})
    return out


def alignment_fwd(prefix, denom):
    """(N, U, S) fp32 alphas: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if prefix.device.type == "cpu":
        return alignment_fwd_plain(prefix, denom)
    prefix, denom = _kernel_args("alignment_fwd", prefix, denom)
    n, u, s = prefix.shape
    alphas = torch.empty_like(prefix)
    _build.launch("simulst_alignment_fwd", prefix.data_ptr(),
                  denom.data_ptr(), alphas.data_ptr(), n, u, s,
                  _build.stream_of(prefix))
    alignment_fwd.launches += 1
    return alphas


def alignment_bwd(prefix, denom, alphas, g):
    """(d_prefix, d_denom), each (N, U, S) fp32: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if prefix.device.type == "cpu":
        return alignment_bwd_plain(prefix, denom, alphas, g)
    prefix, denom, alphas, g = _kernel_args("alignment_bwd", prefix, denom,
                                            alphas, g)
    n, u, s = prefix.shape
    d_prefix, d_denom = torch.empty_like(prefix), torch.empty_like(prefix)
    _build.launch("simulst_alignment_bwd", prefix.data_ptr(),
                  denom.data_ptr(), alphas.data_ptr(), g.data_ptr(),
                  d_prefix.data_ptr(), d_denom.data_ptr(), n, u, s,
                  _build.stream_of(prefix))
    alignment_bwd.launches += 1
    return d_prefix, d_denom


alignment_fwd.launches = 0
alignment_bwd.launches = 0
