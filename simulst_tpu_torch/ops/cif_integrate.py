"""CIF integrate-and-fire as a portion product (counterpart of
simulst_tpu/ops/cif_pallas.py).

With csum = cumsum(alpha) and cprev = csum - alpha over the S source frames
(fp32; csum computed here with torch.cumsum as the JAX package computes it
outside its kernel, cprev by the kernel with the same single rounding),
output bucket t of width beta integrates

    portion[b, s, t] = max(min(csum_s, (t + 1) beta) - max(cprev_s, t beta), 0)
    out[b, t, :]     = sum_s portion[b, s, t] x[b, s, :]
    delays[b, t]     = sum_s portion[b, s, t] (s + 1) / beta

`cif_integrate` runs the CUDA kernel of csrc/cif.cu on a CUDA tensor (it
never forms the (B, S, T) portion tensor) and its plain version
`cif_integrate_plain`, the JAX package's `_cif_matmul_jnp` written in
torch, on a CPU tensor.  The TPU kernel had no backward: JAX takes the vjp
of the einsum twin, and so does the port: under autograd the kernel is the
forward of `_CIFIntegrate`, whose backward differentiates the plain version.
The min / max are torch.minimum / torch.maximum, which split a tie's
gradient as jnp.minimum / jnp.clip do.
"""
from __future__ import annotations

import torch

from simulst_tpu_torch.ops import _build


def cumsums(alpha):
    """(csum, cprev) of (B, S) weights, fp32."""
    alpha = alpha.float()
    csum = torch.cumsum(alpha, dim=1)
    return csum, csum - alpha


def portions(csum, cprev, beta: float, t: int):
    """(B, S, t) overlaps of each frame's [cprev, csum] with each bucket."""
    lo = torch.arange(t, dtype=torch.float32, device=csum.device) * beta
    hi = lo + beta
    p = (torch.minimum(csum[:, :, None], hi)
         - torch.maximum(cprev[:, :, None], lo))
    return torch.maximum(p, p.new_zeros(()))


def cif_integrate_plain(x, alpha, beta: float, t: int):
    """(out (B, t, C) fp32, delays (B, t) fp32) through the (B, S, t)
    portion tensor; differentiable through autograd."""
    csum, cprev = cumsums(alpha)
    portion = portions(csum, cprev, beta, t)
    out = torch.einsum("bst,bsc->btc", portion, x.float())
    pos = torch.arange(x.shape[1], dtype=torch.float32, device=x.device) + 1.0
    delays = torch.einsum("bst,s->bt", portion, pos) / beta
    return out, delays


def cif_integrate_forward(x, alpha, beta: float, t: int):
    """The kernel on CUDA tensors: x (B, S, C), alpha (B, S); raises on
    anything else."""
    if x.ndim != 3 or alpha.shape != x.shape[:2] or min(x.shape) < 1 or t < 1:
        raise ValueError(f"cif_integrate: kernel takes x (B, S, C) and alpha "
                         f"(B, S) with B, S, C >= 1 and t >= 1; got "
                         f"{tuple(x.shape)}, {tuple(alpha.shape)}, t {t}")
    if not beta > 0.0:
        raise ValueError(f"cif_integrate: beta must be positive, got {beta}")
    if x.dtype != torch.float32 or alpha.dtype != torch.float32:
        raise TypeError(f"cif_integrate: kernel takes fp32 x and alpha, got "
                        f"{x.dtype} and {alpha.dtype}")
    # the host work of a call at serving shapes is most of its time: copy
    # nothing that is already contiguous
    if not x.is_contiguous():
        x = x.contiguous()
    csum = torch.cumsum(alpha, dim=1)   # the plain version's, cumsums()
    if not alpha.is_contiguous():
        alpha, csum = alpha.contiguous(), csum.contiguous()
    _build.check_cuda("cif_integrate", x, alpha=alpha)
    b, s, c = x.shape
    out = torch.empty(b, t, c, dtype=torch.float32, device=x.device)
    delays = torch.empty(b, t, dtype=torch.float32, device=x.device)
    _build.launch("simulst_cif_integrate", x.data_ptr(), csum.data_ptr(),
                  alpha.data_ptr(), out.data_ptr(), delays.data_ptr(), b, s,
                  t, c, float(beta), _build.stream_of(x))
    cif_integrate.launches += 1
    return out, delays


class _CIFIntegrate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, beta, t):
        ctx.save_for_backward(x, alpha)
        ctx.beta, ctx.t = beta, t
        return cif_integrate_forward(x, alpha, beta, t)

    @staticmethod
    def backward(ctx, g_out, g_delays):
        x, alpha = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            aa = alpha.detach().requires_grad_()
            out, delays = cif_integrate_plain(xx, aa, ctx.beta, ctx.t)
            dx, da = torch.autograd.grad((out, delays), (xx, aa),
                                         (g_out, g_delays))
        return dx.to(x.dtype), da.to(alpha.dtype), None, None


def cif_integrate(x, alpha, beta: float, t: int):
    """(out (B, t, C) fp32, delays (B, t) fp32): the CUDA kernel on a CUDA
    tensor, under autograd with the plain version's backward; the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return cif_integrate_plain(x, alpha, beta, t)
    if _build.needs_grad(x, alpha):
        return _CIFIntegrate.apply(x, alpha, float(beta), int(t))
    return cif_integrate_forward(x, alpha, float(beta), int(t))


cif_integrate.launches = 0
