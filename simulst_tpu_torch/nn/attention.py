"""Multi-head attention with fixed-capacity incremental KV caches
(counterpart of simulst_tpu/nn/attention.py).

`mha_forward` (full sequences, training and the decoder's cross-attention)
runs the attention core through the `fused_mha` kernel and, given an
epilogue (res, rate, seed), folds `res + dropout(out_proj(.))` into the
`fused_linear_res` kernel, as the JAX package does on the TPU; only
`need_probs=True` takes the plain `attend`, which returns the weights.
Dropout seeds come from the caller (nn/core.RngStream); None means no
dropout.  The cache is a (B, H, Tmax, hd) buffer plus a per-example fill
count.  `kv_cache_append` writes the new step into the buffer in place
(the JAX package returns a new buffer) and returns new counts; rolling
back is keeping the old counts, or a count decrement.
`mha_step` (one query step against the cache) stays plain torch, as in
the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from simulst_tpu_torch.nn.core import Linear, cast, dropout, linear, neg_inf
from simulst_tpu_torch.ops.linear_res import fused_linear_res
from simulst_tpu_torch.ops.mha import fused_mha


class MultiheadAttention(nn.Module):
    """fairseq init: xavier_uniform with gain 1/sqrt(2) on q/k/v when their
    dims match, plain xavier otherwise; out_proj xavier with zero bias."""

    def __init__(self, embed_dim: int, kdim: Optional[int] = None,
                 vdim: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        gain = (1 / math.sqrt(2) if kdim == embed_dim and vdim == embed_dim
                else 1.0)
        self.q_proj = Linear(embed_dim, embed_dim, init="xavier", gain=gain,
                             generator=generator)
        self.k_proj = Linear(kdim, embed_dim, init="xavier", gain=gain,
                             generator=generator)
        self.v_proj = Linear(vdim, embed_dim, init="xavier", gain=gain,
                             generator=generator)
        self.out_proj = Linear(embed_dim, embed_dim, init="xavier",
                               generator=generator)


def _split_heads(x, num_heads: int):
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def attend(q, k, v, *, bias=None, key_valid=None, dropout_rate: float = 0.0,
           seed: Optional[int] = None):
    """q: (B, H, Tq, hd); k, v: (B, H, Tk, hd); bias: additive, broadcastable
    to (B, H, Tq, Tk); key_valid: (B, Tk) bool.  Masked scores are set to
    neg_inf and the softmax runs in fp32, as in the JAX package.  Returns
    (out, probs), probs after dropout."""
    hd = q.shape[-1]
    scores = ((q * (hd ** -0.5)) @ k.transpose(-1, -2)).float()
    if bias is not None:
        scores = scores + bias.float()
    if key_valid is not None:
        scores = scores.masked_fill(~key_valid[:, None, None, :],
                                    neg_inf(q.dtype))
    probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype), dropout_rate,
                    seed)
    return probs @ v, probs


def _merged_linear(parts, x):
    """One product for several same-input projections: x @ [W1|W2|...] +
    [b1|b2|...], split afterwards."""
    w = torch.cat([cast(q.weight, x.dtype) for q in parts], dim=1)
    b = torch.cat([cast(q.bias, x.dtype) for q in parts])
    return (x @ w + b).split([q.weight.shape[1] for q in parts], dim=-1)


def mha_forward(p: MultiheadAttention, query, key, value, num_heads: int, *,
                key_valid=None, causal: bool = False,
                dropout_rate: float = 0.0, seed: Optional[int] = None,
                epilogue=None, need_probs: bool = False):
    """Full-sequence attention.  query: (B, Tq, D); key/value: (B, Tk, D').

    Dropout on the probabilities at dropout_rate when seed is not None.
    epilogue: optional (res, rate, seed): return res + dropout(out_proj(.))
    from one fused_linear_res pass instead of the bare projection.
    Returns (y, probs); probs is None unless need_probs."""
    if query is key and key is value:
        qp, kp, vp = _merged_linear([p.q_proj, p.k_proj, p.v_proj], query)
    elif key is value:
        qp = linear(p.q_proj, query)
        kp, vp = _merged_linear([p.k_proj, p.v_proj], key)
    else:
        qp, kp, vp = (linear(p.q_proj, query), linear(p.k_proj, key),
                      linear(p.v_proj, value))
    rate = dropout_rate if seed is not None else 0.0
    if need_probs:
        bias = None
        if causal:
            tq, tk = qp.shape[1], kp.shape[1]
            blocked = (torch.arange(tk, device=qp.device)[None, :]
                       > torch.arange(tq, device=qp.device)[:, None])
            bias = torch.where(blocked, neg_inf(qp.dtype), 0.0)
        out, probs = attend(_split_heads(qp, num_heads),
                            _split_heads(kp, num_heads),
                            _split_heads(vp, num_heads), bias=bias,
                            key_valid=key_valid, dropout_rate=rate, seed=seed)
        merged = _merge_heads(out)
    else:
        kmask = (torch.ones(kp.shape[:2], dtype=torch.int32, device=kp.device)
                 if key_valid is None else key_valid.to(torch.int32))
        merged = fused_mha(qp, kp, vp, kmask, num_heads, causal, rate,
                           seed or 0)
        probs = None
    if epilogue is not None:
        res, ep_rate, ep_seed = epilogue
        d = merged.dtype
        y = fused_linear_res(merged, cast(p.out_proj.weight, d),
                             cast(p.out_proj.bias, d), res.to(d),
                             rate=ep_rate if ep_seed is not None else 0.0,
                             seed=ep_seed or 0)
        return y, probs
    return linear(p.out_proj, merged), probs


class KVCache(NamedTuple):
    """Fixed-capacity incremental KV cache; `length` is per example."""
    k: torch.Tensor        # (B, H, Tmax, hd)
    v: torch.Tensor        # (B, H, Tmax, hd)
    length: torch.Tensor   # (B,) int64 — valid entries per example


def kv_cache_init(batch: int, num_heads: int, max_len: int, head_dim: int,
                  dtype=torch.float32, device=None) -> KVCache:
    shape = (batch, num_heads, max_len, head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros(batch, dtype=torch.int64, device=device))


def kv_cache_append(cache: KVCache, k_new, v_new) -> KVCache:
    """Write one step (B, H, 1, hd) at each example's fill position, in
    place, and return the cache with the counts advanced in a new tensor:
    the cache passed in keeps its counts, so keeping it (per example, as an
    MMA READ does) rolls the step back."""
    rows = torch.arange(cache.k.shape[0], device=cache.k.device)
    cache.k[rows, :, cache.length] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[rows, :, cache.length] = v_new[:, :, 0].to(cache.v.dtype)
    return cache._replace(length=cache.length + 1)


def kv_cache_rollback(cache: KVCache, n: int = 1) -> KVCache:
    """Discard the last n appended entries: validity is the count."""
    return cache._replace(length=torch.clamp_min(cache.length - n, 0))


def mha_step(p: MultiheadAttention, cache: KVCache, query_step,
             num_heads: int) -> Tuple[torch.Tensor, KVCache]:
    """Incremental self-attention for ONE new step; query_step (B, 1, D)."""
    q = _split_heads(linear(p.q_proj, query_step), num_heads)
    k_new = _split_heads(linear(p.k_proj, query_step), num_heads)
    v_new = _split_heads(linear(p.v_proj, query_step), num_heads)
    cache = kv_cache_append(cache, k_new, v_new)
    tmax = cache.k.shape[2]
    valid = torch.arange(tmax, device=q.device)[None, :] < cache.length[:, None]
    out, _ = attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                    key_valid=valid)
    return linear(p.out_proj, _merge_heads(out)), cache
