"""Core parameter modules and functions (counterpart of simulst_tpu/nn/core.py).

Parameters live in small `nn.Module`s whose attribute names mirror the JAX
pytree keys, so `compat/jax_bridge.py` maps a JAX tree onto a state_dict by
joining the path.  Linear weights keep the JAX layout (in, out):
y = x @ W + b, which is also the layout the kernels take.

Numerics follow the JAX package: LayerNorm eps 1e-5 with fp32 statistics,
exact (erf) GELU, parameters cast to the activation dtype per op (`cast`,
which keeps a parameter's cast while nothing changes it and grad is off).

Initialisers draw from an explicit CPU `torch.Generator` with the JAX
package's distributions (the numbers differ from jax.random's; tests that
need equal weights bridge them from JAX instead).  Dropout draws from an
explicit generator too: `RngStream` (the JAX package's _RngStream) hands out
one seed per dropout site, and `dropout` turns a seed into a mask on the
tensor's own device.  Entry points place their weights on the card unless
the caller names another device (`resolve_device`).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# -1e4 under 16-bit activations, -1e8 in fp32 (reference s2t_emformer.py:89)
NEG_INF_BF16 = -1e4
NEG_INF_F32 = -1e8


def neg_inf(dtype) -> float:
    return NEG_INF_F32 if dtype == torch.float32 else NEG_INF_BF16


def gelu(x):
    """Exact (erf) GELU, torch.nn.GELU's default."""
    return F.gelu(x)


def glu(x, dim: int = -1):
    return F.glu(x, dim=dim)


ACTIVATIONS = {"relu": torch.relu, "gelu": gelu, "silu": F.silu,
               "tanh": torch.tanh}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `compute_dtype` string ("float32",
    "bfloat16")."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype {name!r} is not a torch float dtype")
    return dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another (the tests pass "cpu")."""
    return torch.device("cuda") if device is None else torch.device(device)


class RngStream:
    """Seeds for the dropout sites of one forward pass, drawn from a CPU
    `torch.Generator` (no device synchronisation).  Counterpart of the JAX
    package's nn/transformer._RngStream; None-safe through `next_seed`."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def next(self) -> int:
        return int(torch.randint(0, 2 ** 62, (1,),
                                 generator=self.generator).item())


def next_seed(rngs: Optional[RngStream]) -> Optional[int]:
    return None if rngs is None else rngs.next()


def dropout(x, rate: float, seed: Optional[int]):
    """Inverted dropout with its mask drawn on x's device from a generator
    seeded with `seed`; identity when seed is None or rate is 0 (the JAX
    package's deterministic / rng-None cases)."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def masked_softmax(scores, visible):
    """Row-max softmax over the last axis of fp32 `scores`, restricted to
    `visible` (broadcastable bool).  A row with no visible entry comes out as
    exact zeros, as the Emformer's softmax does in the JAX package
    (nn/emformer.py _attn_softmax), not as NaN or a uniform average."""
    s = scores.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    # a row with a visible entry sums to >= 1; an empty row sums to 0
    return e / e.sum(dim=-1, keepdim=True).clamp_min(1.0)


# ---------------------------------------------------------------------------
# initialisers (CPU generator; modules are moved to their device afterwards)
# ---------------------------------------------------------------------------

def uniform(shape, bound: float, generator: Optional[torch.Generator]):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def normal(shape, std: float, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator) * std


def _linear_weight(in_dim, out_dim, init, gain, generator):
    if init == "torch":       # kaiming_uniform(a=sqrt 5) for fan_in = in_dim
        return uniform((in_dim, out_dim), math.sqrt(1.0 / in_dim), generator)
    if init == "xavier":
        a = gain * math.sqrt(6.0 / (in_dim + out_dim))
        return uniform((in_dim, out_dim), a, generator)
    if init == "normal":
        return normal((in_dim, out_dim), gain, generator)
    raise ValueError(init)


class Linear(nn.Module):
    """y = x @ weight + bias with weight stored (in, out)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 init: str = "torch", gain: float = 1.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            _linear_weight(in_dim, out_dim, init, gain, generator))
        if bias:
            b = (uniform((out_dim,), math.sqrt(1.0 / in_dim), generator)
                 if init == "torch" else torch.zeros(out_dim))
            self.bias = nn.Parameter(b)
        else:
            self.register_parameter("bias", None)


# inside `step_casts`: ({id: (parameter, dtype, uses)}, {id: its cast})
_STEP_CASTS = contextvars.ContextVar("step_casts", default=None)


def cast(t, dtype):
    """`t` in `dtype`, as the JAX package casts its fp32 parameters per op;
    the backward carries the gradient to the fp32 parameter.  With grad on
    each call casts, unless `step_casts` made the parameter's cast for the
    step.  With grad off (serving, evaluation) the cast of a parameter is
    kept on it until the parameter changes (its version, storage or
    device), so that a decode step reads the weights in the compute dtype
    without casting them again.  The values are the same either way.  A
    parameter made in inference mode has no version to watch, so each
    call casts it."""
    if t.dtype == dtype:
        return t
    if not isinstance(t, nn.Parameter):
        return t.to(dtype)
    if torch.is_grad_enabled():
        step = _STEP_CASTS.get()
        if step is None:
            return t.to(dtype)
        uses, made = step
        seen = uses.get(id(t))
        uses[id(t)] = (t, dtype, 1 if seen is None else seen[2] + 1)
        view = made.get(id(t))
        return view if view is not None and view.dtype == dtype else \
            t.to(dtype)
    if t.is_inference():
        return t.to(dtype)
    key = (dtype, t._version, t.data_ptr(), t.device)
    kept = getattr(t, "_kept_cast", None)
    if kept is None or kept[0] != key:
        kept = (key, t.to(dtype))
        t._kept_cast = kept
    return kept[1]


@contextlib.contextmanager
def step_casts(module: nn.Module):
    """One train step's forward (grad on).  The parameters of `module`
    that `cast` handed out exactly once in the previous step's forward are
    cast together, by one concatenation and one cast, and `cast` returns
    views of the result; the backward casts their gradients back in one
    pass.  That replaces a cast and a gradient cast per parameter (about
    490 of a bf16 s2t_emformer_s step's kernels on an H100, PERF.md) by
    four, with the same values and gradients.  A parameter used more than once keeps a cast per use,
    so that its gradients are summed in fp32, as the JAX package sums
    them."""
    groups = {}
    for p in module.parameters():
        dtype = getattr(p, "_step_cast", None)
        if dtype is not None and p.requires_grad and p.dtype != dtype:
            groups.setdefault(dtype, []).append(p)
    made = {}
    for dtype, ps in groups.items():
        flat = torch.cat([p.reshape(-1) for p in ps]).to(dtype)
        for p, v in zip(ps, flat.split([p.numel() for p in ps])):
            made[id(p)] = v.view(p.shape)
    uses = {}
    token = _STEP_CASTS.set((uses, made))
    try:
        yield
    finally:
        _STEP_CASTS.reset(token)
        for p in module.parameters():
            seen = uses.get(id(p))
            p._step_cast = seen[1] if seen is not None and seen[2] == 1 \
                else None


def linear(p, x):
    y = x @ cast(p.weight, x.dtype)
    if p.bias is not None:
        y = y + cast(p.bias, x.dtype)
    return y


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


def layer_norm(p, x, eps: float = 1e-5):
    """Statistics in fp32 whatever the activation dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


class Embedding(nn.Module):
    """fairseq Embedding: normal(0, d^-0.5), padding row zeroed."""

    def __init__(self, num_embeddings: int, dim: int,
                 padding_idx: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = normal((num_embeddings, dim), dim ** -0.5, generator)
        if padding_idx is not None:
            w[padding_idx] = 0.0
        self.weight = nn.Parameter(w)


def embedding(p, ids, dtype=None):
    """Rows of the table, cast to `dtype` when given (the JAX package's
    embedding(..., dtype=compute_dtype))."""
    rows = p.weight[ids]
    return rows if dtype is None else rows.to(dtype)


def lengths_to_mask(lengths, max_len: int):
    """(B,) -> (B, T) bool, True on VALID positions."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]
