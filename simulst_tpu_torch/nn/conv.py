"""Causal convolutions with fixed-size streaming caches (counterpart of
simulst_tpu/nn/conv.py).

Activations keep the JAX layout (B, T, C); conv weights are stored in torch's
(Cout, Cin/groups, K) layout for `F.conv1d` (the bridge permutes the JAX
(K, Cin/groups, Cout) weights).  Offline: left-pad k-1 zeros and run one
conv.  Streaming: the cache holds the last k-1 input frames (zeros at start
== the left pad); every chunk length must be a multiple of the stride for
streaming == offline.  The offline conv-pos runs through
ops/conv_pos.py's `grouped_conv_fast_wgrad`, whose weight gradient is a
kernel (the JAX package's custom VJP); the weight norm's gradient to g and
v is autograd's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simulst_tpu_torch.nn.core import (Linear, cast, gelu, glu, linear, normal,
                                       uniform)
from simulst_tpu_torch.ops.conv_pos import conv1d, grouped_conv_fast_wgrad


class CausalConv1d(nn.Module):
    """torch.nn.Conv1d default init (kaiming_uniform a=sqrt 5)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(1.0 / (in_channels * kernel_size))
        self.weight = nn.Parameter(uniform(
            (out_channels, in_channels, kernel_size), bound, generator))
        self.bias = nn.Parameter(uniform((out_channels,), bound, generator))


def _conv1d(x, w, stride: int = 1, groups: int = 1):
    """x: (B, T, Cin); w: (Cout, Cin/groups, K) -> (B, T', Cout), VALID."""
    y = conv1d(x.transpose(1, 2), cast(w, x.dtype), stride=stride,
               groups=groups)
    return y.transpose(1, 2)


def _kernel_size(p) -> int:
    return p.weight.shape[-1]


def causal_conv1d(p, x, stride: int = 1):
    k = _kernel_size(p)
    return _conv1d(F.pad(x, (0, 0, k - 1, 0)), p.weight, stride) + \
        cast(p.bias, x.dtype)


class ConvCache(NamedTuple):
    """Last k-1 input frames (zeros == the initial left pad)."""
    feat: torch.Tensor  # (B, k-1, Cin)


def causal_conv1d_step(p, cache: ConvCache, x, stride: int = 1
                       ) -> Tuple[torch.Tensor, ConvCache]:
    """Conv over [cache (k-1), chunk]; the cache becomes the last k-1 frames
    of that concatenation.  x: (B, c, Cin), c % stride == 0; an empty
    chunk gives no frames and keeps the cache."""
    k = _kernel_size(p)
    if x.shape[1] == 0:
        return x.new_zeros(x.shape[0], 0, p.weight.shape[0]), cache
    full = torch.cat([cache.feat, x], dim=1)
    y = _conv1d(full, p.weight, stride) + cast(p.bias, x.dtype)
    return y, ConvCache(feat=full[:, full.shape[1] - (k - 1):])


def conv_out_length(length, kernel_size: int, stride: int):
    """floor((L - 1) / s) + 1, the causal conv's output length."""
    return torch.div(length - 1, stride, rounding_mode="floor") + 1


# ---------------------------------------------------------------------------
# CausalConv1dSubsampler: 2x (stride-2 causal conv + GLU) = 4x subsampling
# ---------------------------------------------------------------------------

class Subsampler(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 5), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n = len(kernel_sizes)
        self.layers = nn.ModuleList(
            CausalConv1d(in_channels if i == 0 else mid_channels // 2,
                         mid_channels if i < n - 1 else out_channels * 2, k,
                         generator=generator)
            for i, k in enumerate(kernel_sizes))


def subsampler_out_lengths(p, lengths):
    out = lengths
    for layer in p.layers:
        out = conv_out_length(out, _kernel_size(layer), 2)
    return out


def subsampler_apply(p, x, lengths):
    """x: (B, T, F) -> (B, ceil(T/4), D), out_lengths."""
    for layer in p.layers:
        x = glu(causal_conv1d(layer, x, stride=2), dim=-1)
    return x, subsampler_out_lengths(p, lengths)


class SubsamplerCache(NamedTuple):
    caches: Tuple[ConvCache, ...]


def subsampler_init_cache(p, batch: int, dtype=torch.float32,
                          device=None) -> SubsamplerCache:
    return SubsamplerCache(caches=tuple(
        ConvCache(feat=torch.zeros(batch, _kernel_size(layer) - 1,
                                   layer.weight.shape[1], dtype=dtype,
                                   device=device))
        for layer in p.layers))


def subsampler_step(p, cache: SubsamplerCache, x
                    ) -> Tuple[torch.Tensor, SubsamplerCache]:
    """Streaming subsample of a NEW chunk (B, c, F), c % 4 == 0 for parity."""
    new = []
    for layer, c in zip(p.layers, cache.caches):
        x, nc = causal_conv1d_step(layer, c, x, stride=2)
        x = glu(x, dim=-1)
        new.append(nc)
    return x, SubsamplerCache(caches=tuple(new))


# ---------------------------------------------------------------------------
# causal convolutional positional embedding (weight-normed grouped conv+GELU)
# ---------------------------------------------------------------------------

class ConvPos(nn.Module):
    """Kernel (conv_pos+1)//2 (the causal conv-pos), or `kernel` taps (the
    non-causal one's full conv_pos), grouped; weight norm per tap over
    (Cout, Cin/g), i.e. torch weight_norm dim=2 on (Cout, Cin/g, K)."""

    def __init__(self, embed_dim: int, conv_pos: int, groups: int, *,
                 kernel: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = (conv_pos + 1) // 2 if kernel is None else kernel
        v = normal((embed_dim, embed_dim // groups, k),
                   math.sqrt(4.0 / (conv_pos * embed_dim)), generator)
        self.v = nn.Parameter(v)
        self.g = nn.Parameter((v ** 2).sum(dim=(0, 1), keepdim=True).sqrt())
        self.bias = nn.Parameter(torch.zeros(embed_dim))


def _conv_pos_weight(p):
    """g * v / (||v|| + 1e-12) per tap, the JAX formula (nn/conv.py:220-223)."""
    v = p.v.float()
    norm = (v ** 2).sum(dim=(0, 1), keepdim=True).sqrt() + 1e-12
    return p.g.float() * v / norm


def conv_pos_apply(p, x, groups: int):
    """x: (B, T, D) -> GELU'd positional features (B, T, D)."""
    w = _conv_pos_weight(p).to(x.dtype)
    k = w.shape[-1]
    y = grouped_conv_fast_wgrad(F.pad(x, (0, 0, k - 1, 0)), w, groups)
    return gelu(y + cast(p.bias, x.dtype))


def conv_pos_init_cache(p, batch: int, embed_dim: int, dtype=torch.float32,
                        device=None) -> ConvCache:
    k = p.v.shape[-1]
    return ConvCache(feat=torch.zeros(batch, k - 1, embed_dim, dtype=dtype,
                                      device=device))


def conv_pos_step(p, cache: ConvCache, x, groups: int
                  ) -> Tuple[torch.Tensor, ConvCache]:
    w = _conv_pos_weight(p)
    k = w.shape[-1]
    full = torch.cat([cache.feat, x], dim=1)
    y = _conv1d(full, w, 1, groups) + cast(p.bias, x.dtype)
    return gelu(y), ConvCache(feat=full[:, full.shape[1] - (k - 1):])


# ---------------------------------------------------------------------------
# CausalVGGBlock: the alternative ConvTransformer pre-net (reference
# causal_conv.py:165-228; no shipped recipe uses it).  The JAX package
# computes it in XLA with no Pallas kernel; F.conv2d here.
# ---------------------------------------------------------------------------

class VGGConv(nn.Module):
    """One 2-D conv of the block: weight (Cout, Cin, Kt, Kf), torch's
    layout (the bridge permutes JAX's (Kt, Kf, Cin, Cout))."""

    def __init__(self, cin: int, cout: int, k: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = math.sqrt(1.0 / (cin * k * k))
        self.weight = nn.Parameter(uniform((cout, cin, k, k), bound,
                                           generator))
        self.bias = nn.Parameter(uniform((cout,), bound, generator))


class VGGBlock(nn.Module):
    """Stride-2 k x k convs + ReLU over (time, frequency), then a linear
    from the flattened (frequency, channel) axis to out_channels."""

    def __init__(self, input_dim: int = 80, in_channels: int = 1,
                 mid_channels: int = 256, out_channels: int = 256,
                 kernel_sizes: Sequence[int] = (3, 3), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = input_dim
        layers = []
        for i, k in enumerate(kernel_sizes):
            layers.append(VGGConv(in_channels if i == 0 else mid_channels,
                                  mid_channels, k, generator=generator))
            f = (f + 2 * (k // 2) - k) // 2 + 1   # SAME pad in frequency
        self.layers = nn.ModuleList(layers)
        self.out = Linear(f * mid_channels, out_channels, generator=generator)
        self.kernel_sizes = tuple(kernel_sizes)


def vgg_block_apply(p: VGGBlock, x, lengths):
    """x: (B, T, F) -> ((B, T', D), lengths'): causal in time (left pad
    k-1), SAME in frequency, stride 2 in both."""
    h = x[:, None]                                         # (B, 1, T, F)
    for layer, k in zip(p.layers, p.kernel_sizes):
        h = F.pad(h, (k // 2, k // 2, k - 1, 0))
        h = torch.relu(F.conv2d(h, cast(layer.weight, h.dtype),
                                cast(layer.bias, h.dtype), stride=2))
        lengths = conv_out_length(lengths, k, 2)
    b, c, t, f = h.shape
    return linear(p.out, h.permute(0, 2, 3, 1).reshape(b, t, f * c)), lengths
