"""Transformer decoder with incremental steps (counterpart of
simulst_tpu/nn/transformer.py).

fairseq semantics as configured by s2t_emformer_s and transformer_small:
pre-LN (or post-LN with normalize_before=False), sinusoidal positions with
the padding_idx offset, a GELU, ReLU, SiLU or tanh FFN, shared
input/output embedding.  The token embedding comes out in the config's
`compute_dtype`, and every later op computes in its input's dtype with
the parameters cast per op.  On
the card every layer runs its attention cores through `fused_mha`, its
attention epilogues through `fused_linear_res` and its FFN through
`fused_ffn`.  The teacher-forced forward takes an `RngStream`: each
dropout site draws one seed from it, and without one nothing is dropped
(the JAX package's deterministic mode).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn.core import (Embedding, LayerNorm, Linear, RngStream,
                                       cast, compute_dtype, dropout, embedding,
                                       layer_norm, linear, next_seed,
                                       resolve_device)
from simulst_tpu_torch.ops.ffn import fused_ffn


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int
    embed_dim: int = 256
    ffn_dim: int = 2048
    num_layers: int = 6
    num_heads: int = 4
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "gelu"
    normalize_before: bool = True
    share_input_output_embed: bool = True
    padding_idx: int = 1
    eos_idx: int = 2
    encoder_embed_dim: int = 256
    max_target_positions: int = 1024
    no_scale_embedding: bool = False
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)

    @property
    def embed_scale(self) -> float:
        return 1.0 if self.no_scale_embedding else math.sqrt(self.embed_dim)


def sinusoidal_table(num_embeddings: int, dim: int, padding_idx: int):
    """fairseq SinusoidalPositionalEmbedding table, padding row zeroed."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32) * -emb)
    args = torch.arange(num_embeddings, dtype=torch.float32)[:, None] * freqs[None, :]
    table = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        table = torch.cat([table, torch.zeros(num_embeddings, 1)], dim=1)
    table[padding_idx] = 0.0
    return table


def positions_from_tokens(tokens, padding_idx: int):
    """fairseq make_positions: pads stay padding_idx, others count from
    padding_idx + 1."""
    mask = tokens != padding_idx
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DecoderConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        self.encoder_attn = attn.MultiheadAttention(
            d, kdim=cfg.encoder_embed_dim, vdim=cfg.encoder_embed_dim,
            generator=generator)
        self.encoder_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, cfg.ffn_dim, generator=generator)
        self.fc2 = Linear(cfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)


class Decoder(nn.Module):
    """Weights from a seeded CPU generator, then moved to `device` (the card
    unless the caller names another).  make_layer() builds each layer in
    place of a DecoderLayer (the MMA decoder's monotonic layers)."""

    def __init__(self, cfg: DecoderConfig, *,
                 generator: Optional[torch.Generator] = None, device=None,
                 make_layer: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.embed_dim,
                                      cfg.padding_idx, generator=generator)
        make_layer = make_layer or (lambda: DecoderLayer(cfg,
                                                         generator=generator))
        self.layers = nn.ModuleList(make_layer()
                                    for _ in range(cfg.num_layers))
        self.layer_norm = LayerNorm(cfg.embed_dim)
        if not cfg.share_input_output_embed:
            self.output_projection = Linear(
                cfg.embed_dim, cfg.vocab_size, bias=False, init="normal",
                gain=cfg.embed_dim ** -0.5, generator=generator)
        self.register_buffer(
            "pos_table",
            sinusoidal_table(cfg.max_target_positions + cfg.padding_idx + 1,
                             cfg.embed_dim, cfg.padding_idx),
            persistent=False)
        self.to(resolve_device(device))


def _ffn(p: DecoderLayer, cfg: DecoderConfig, x,
         rngs: Optional[RngStream] = None):
    """x + drop_o(fc2(drop_a(act(fc1(LN(x)))))) (post-LN: LN(x + ...(x))):
    one fused_ffn pass; one seed keys both dropout sites."""
    h = layer_norm(p.final_ln, x) if cfg.normalize_before else x
    d = h.dtype
    seed = next_seed(rngs)
    on = seed is not None
    y = x + fused_ffn(h, cast(p.fc1.weight, d), cast(p.fc1.bias, d),
                      cast(p.fc2.weight, d), cast(p.fc2.bias, d),
                      cfg.activation,
                      cfg.activation_dropout if on else 0.0,
                      cfg.dropout if on else 0.0, seed or 0)
    return y if cfg.normalize_before else layer_norm(p.final_ln, y)


def _sublayer(p_attn, p_ln, cfg: DecoderConfig, x, key_value, *,
              key_valid=None, causal=False, rngs: Optional[RngStream] = None,
              normalize_before: bool = True):
    """x + dropout(attention(LN(x))) (post-LN: LN(x + dropout(attention(
    x)))); self-attention when key_value is None.  The residual add and its
    dropout are the fused_linear_res epilogue.  Only the decoder layer
    passes cfg.normalize_before: the MMA, CIF and label-encoder layers are
    pre-LN in their attention sublayers whatever the config, as in the JAX
    package."""
    h = layer_norm(p_ln, x) if normalize_before else x
    kv = h if key_value is None else key_value
    y, _ = attn.mha_forward(p_attn, h, kv, kv, cfg.num_heads,
                            key_valid=key_valid, causal=causal,
                            dropout_rate=cfg.attention_dropout,
                            seed=next_seed(rngs),
                            epilogue=(x, cfg.dropout, next_seed(rngs)))
    return y if normalize_before else layer_norm(p_ln, y)


def decoder_layer_forward(p: DecoderLayer, cfg: DecoderConfig, x, encoder_out,
                          encoder_valid, *, self_attn_valid=None,
                          rngs: Optional[RngStream] = None):
    """Teacher-forced layer. x: (B, T, D); encoder_out: (B, S, De)."""
    pre = cfg.normalize_before
    x = _sublayer(p.self_attn, p.self_attn_ln, cfg, x, None,
                  key_valid=self_attn_valid, causal=True, rngs=rngs,
                  normalize_before=pre)
    x = _sublayer(p.encoder_attn, p.encoder_attn_ln, cfg, x, encoder_out,
                  key_valid=encoder_valid, rngs=rngs, normalize_before=pre)
    return _ffn(p, cfg, x, rngs)


def decoder_layer_step(p: DecoderLayer, cfg: DecoderConfig,
                       cache: attn.KVCache, x_step, encoder_out,
                       encoder_valid) -> Tuple[torch.Tensor, attn.KVCache]:
    """Incremental step (no dropout). x_step: (B, 1, D)."""
    pre = cfg.normalize_before
    out, cache = attn.mha_step(
        p.self_attn, cache,
        layer_norm(p.self_attn_ln, x_step) if pre else x_step, cfg.num_heads)
    x = x_step + out
    if not pre:
        x = layer_norm(p.self_attn_ln, x)
    x = _sublayer(p.encoder_attn, p.encoder_attn_ln, cfg, x, encoder_out,
                  key_valid=encoder_valid, normalize_before=pre)
    return _ffn(p, cfg, x), cache


def output_layer(p: Decoder, cfg: DecoderConfig, x):
    if cfg.share_input_output_embed:
        return x @ cast(p.embed_tokens.weight, x.dtype).T
    return linear(p.output_projection, x)


def decoder_embed(p: Decoder, cfg: DecoderConfig, tokens, positions,
                  rngs: Optional[RngStream] = None):
    x = cfg.embed_scale * embedding(p.embed_tokens, tokens, cfg.dtype)
    x = x + p.pos_table[positions].to(x.dtype)
    return dropout(x, cfg.dropout, next_seed(rngs))


def decoder_forward(p: Decoder, cfg: DecoderConfig, prev_tokens, encoder_out,
                    encoder_valid, *, rngs: Optional[RngStream] = None,
                    features_only: bool = False):
    """Teacher-forced forward. prev_tokens: (B, T) with EOS moved to front.
    Dropout at the config's rates when rngs is given."""
    positions = positions_from_tokens(prev_tokens, cfg.padding_idx)
    x = decoder_embed(p, cfg, prev_tokens, positions, rngs)
    self_valid = prev_tokens != cfg.padding_idx
    for layer in p.layers:
        x = decoder_layer_forward(layer, cfg, x, encoder_out, encoder_valid,
                                  self_attn_valid=self_valid, rngs=rngs)
    x = layer_norm(p.layer_norm, x)
    return x if features_only else output_layer(p, cfg, x)


class DecoderState(NamedTuple):
    caches: Tuple[attn.KVCache, ...]
    step: torch.Tensor  # (B,) tokens consumed so far, per example


def decoder_init_state(cfg: DecoderConfig, batch: int, max_len: int,
                       dtype=None, device=None) -> DecoderState:
    """The KV caches in `dtype`, by default the config's compute dtype."""
    dtype = cfg.dtype if dtype is None else dtype
    hd = cfg.embed_dim // cfg.num_heads
    caches = tuple(attn.kv_cache_init(batch, cfg.num_heads, max_len, hd,
                                      dtype, device)
                   for _ in range(cfg.num_layers))
    return DecoderState(caches=caches,
                        step=torch.zeros(batch, dtype=torch.int64,
                                         device=device))


def decoder_step(p: Decoder, cfg: DecoderConfig, state: DecoderState, token,
                 encoder_out, encoder_valid
                 ) -> Tuple[torch.Tensor, DecoderState]:
    """One greedy/beam step. token: (B,) the previous token.  The KV caches
    are appended in place; returns (logits (B, V), state)."""
    pos = cfg.padding_idx + 1 + state.step
    x = decoder_embed(p, cfg, token[:, None], pos[:, None])
    caches = []
    for layer, cache in zip(p.layers, state.caches):
        x, cache = decoder_layer_step(layer, cfg, cache, x, encoder_out,
                                      encoder_valid)
        caches.append(cache)
    x = layer_norm(p.layer_norm, x)
    logits = output_layer(p, cfg, x)
    return logits[:, 0], DecoderState(caches=tuple(caches), step=state.step + 1)
