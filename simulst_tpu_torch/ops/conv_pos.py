"""The grouped causal conv-pos convolution with its weight gradient as a
kernel (counterpart of simulst_tpu/ops/conv_pos_pallas.py
`convpos_wgrad_pallas` and the custom VJP of simulst_tpu/nn/conv.py
`_grouped_conv_fast_wgrad`).

`grouped_conv_fast_wgrad(xp, w, groups)` is the VALID grouped convolution
of the left-padded input xp (B, T + K - 1, D) with w (D, D / groups, K),
torch's conv layout (the JAX package keeps (K, D / groups, D)).  Its
forward and its input gradient are ordinary convolutions (`F.conv1d`,
`torch.nn.grad.conv1d_input`), as they are XLA convolutions in the JAX
package; its weight gradient is `convpos_wgrad`: the CUDA kernel of
csrc/conv_pos.cu on a CUDA tensor (any number D / groups of channels per
group: `check_channels`; a count other than 1 that is not a multiple of 4
reaches it with each group zero-padded to the next multiple of 4, and the
gradient is sliced back), the plain version
`convpos_wgrad_plain` on a CPU tensor.  Both sum in fp32 and
compute only the block-diagonal part of each tap's product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from simulst_tpu_torch.ops import _build

CHANNEL_STEP = 4    # channels per group the kernel takes: 1 or a multiple
                    # of this; others are padded
BATCH_SPLITS = 8          # batch slices the kernel sums as fp32 partials


def convpos_wgrad_plain(xp, dy, taps: int, groups: int):
    """dw (D, D / groups, K) fp32 with dw[o, ci, k] = sum over (b, t) of
    xp[b, t + k, group(o) * cg + ci] * dy[b, t, o]."""
    b, t_in, d = xp.shape
    t = dy.shape[1]
    cg = d // groups
    x = xp.float().reshape(b, t_in, groups, cg)
    g = dy.float().reshape(b * t, groups, cg)
    dw = torch.empty(d, cg, taps, dtype=torch.float32, device=xp.device)
    for k in range(taps):
        xk = x[:, k:k + t].reshape(b * t, groups, cg)
        dw[:, :, k] = torch.einsum("ngc,ngo->goc", xk, g).reshape(d, cg)
    return dw


def check_channels(name: str, d: int, groups: int) -> int:
    """The channels per group D / groups; a ValueError naming them unless
    the kernel takes them (at least one, D a whole number of groups)."""
    cg = d // groups if groups > 0 else 0
    if groups <= 0 or cg * groups != d or cg < 1:
        raise ValueError(
            f"{name}: kernel takes a positive number of channels per group, "
            f"D a whole number of groups; got D {d} in {groups} groups")
    return cg


def padded_channels(cg: int) -> int:
    """The channels per group the kernel takes for cg: 1, or the next
    multiple of CHANNEL_STEP."""
    return 1 if cg == 1 else _build.round_up(cg, CHANNEL_STEP)


def _launch(xp, dy, taps: int, groups: int):
    b, t_in, d = xp.shape
    t = dy.shape[1]
    if dy.shape != (b, t, d) or t_in != t + taps - 1:
        raise ValueError(
            f"convpos_wgrad: kernel takes xp (B, T + K - 1, D), dy (B, T, "
            f"D); got xp {tuple(xp.shape)}, dy {tuple(dy.shape)}, {taps} "
            f"taps")
    cg_real = check_channels("convpos_wgrad", d, groups)
    xp, dy = xp.contiguous(), dy.contiguous()
    _build.check_cuda("convpos_wgrad", xp, dy=dy)
    cg = padded_channels(cg_real)
    xp, dy = (_build.padded_groups(t, groups, cg) for t in (xp, dy))
    d = groups * cg
    xp, dy = _build.aligned(xp), _build.aligned(dy)   # the 16-byte copies
    f32 = dict(dtype=torch.float32, device=xp.device)
    splits = min(BATCH_SPLITS, b)
    splits = -(-b // -(-b // splits))        # the slices the kernel forms
    dw = torch.empty(d, cg, taps, **f32)
    partial = torch.empty(splits, d, cg, taps, **f32)
    _build.launch("simulst_convpos_wgrad", _build.dtype_code(xp),
                  xp.data_ptr(), dy.data_ptr(), dw.data_ptr(),
                  partial.data_ptr(), b, t, taps, d, groups, splits,
                  _build.stream_of(xp))
    convpos_wgrad.launches += 1
    if cg == cg_real:
        return dw
    # dw[g cg + o, i] of the padded groups: keep o, i < cg_real
    dw = dw.view(groups, cg, cg, taps)[:, :cg_real, :cg_real]
    return dw.reshape(groups * cg_real, cg_real, taps)


def convpos_wgrad(xp, dy, taps: int, groups: int):
    """Weight gradient (D, D / groups, K) fp32 of the grouped conv of xp
    (B, T + K - 1, D) for output gradient dy (B, T, D): the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    if xp.device.type == "cpu":
        return convpos_wgrad_plain(xp, dy, taps, groups)
    return _launch(xp, dy, taps, groups)


def _cpu_bf16(t) -> bool:
    return t.device.type == "cpu" and t.dtype == torch.bfloat16


def conv1d(x, w, stride: int = 1, groups: int = 1):
    """F.conv1d on (B, C, T) input.  torch's CPU convolutions in bf16 sum
    grouped products in bf16 (an abs error of 3.4 on outputs of 3.1 at 64
    taps x 4 channels, torch 2.13), so on the CPU a bf16 conv takes fp32
    operands and rounds its output, as XLA's and cuDNN's bf16 convs do."""
    if _cpu_bf16(x):
        return F.conv1d(x.float(), w.float(), stride=stride,
                        groups=groups).to(x.dtype)
    return F.conv1d(x, w, stride=stride, groups=groups)


def _conv(xp, w, groups):
    return conv1d(xp.transpose(1, 2), w, groups=groups).transpose(1, 2)


def _conv_input_grad(xp, w, dy, groups):
    """The conv's input gradient, with conv1d's fp32 route on a CPU bf16
    tensor."""
    shape = xp.transpose(1, 2).shape
    if _cpu_bf16(dy):
        return torch.nn.grad.conv1d_input(
            shape, w.float(), dy.float().transpose(1, 2),
            groups=groups).to(dy.dtype).transpose(1, 2)
    return torch.nn.grad.conv1d_input(shape, w, dy.transpose(1, 2),
                                      groups=groups).transpose(1, 2)


class _GroupedConvFastWgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w, groups):
        ctx.save_for_backward(xp, w)
        ctx.groups = groups
        return _conv(xp, w, groups)

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        dxp = dw = None
        if ctx.needs_input_grad[0]:
            dxp = _conv_input_grad(xp, w, dy, ctx.groups)
        if ctx.needs_input_grad[1]:
            dw = convpos_wgrad(xp, dy, w.shape[-1], ctx.groups).to(w.dtype)
        return dxp, dw, None


def grouped_conv_fast_wgrad(xp, w, groups: int):
    """VALID grouped conv, xp (B, T + K - 1, D), w (D, D / groups, K) ->
    (B, T, D); its weight gradient is `convpos_wgrad`."""
    if not _build.needs_grad(xp, w):
        return _conv(xp, w, groups)
    return _GroupedConvFastWgrad.apply(xp, w, groups)


convpos_wgrad.launches = 0
