"""MT transformer (`transformer_small`), the sequence-KD teacher
(counterpart of simulst_tpu/models/mt_transformer.py).

256-d, 4 heads, 6 + 6 layers, FFN 2048 with relu, pre-LN, dropout 0.1
everywhere, one embedding shared by the encoder input, the decoder input
and the output projection.  The encoder layers keep their FFN as plain
linear + act + dropout, exactly as the JAX package does (its fused FFN
kernel serves the decoder only); every attention core is `fused_mha`.

Shared embeddings start shared and train apart, as in the JAX package:
its init puts one array under `encoder.embed_tokens` and
`decoder.embed_tokens`, but the two are separate pytree leaves, each with
its own gradient and Adam moments (the decoder's serving the decoder input
and the output projection).  So here `decoder.embed_tokens` is its own
parameter, initialised to a copy of the encoder's.  fairseq's
share_all_embeddings would tie them into one; ROADMAP notes the difference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (ACTIVATIONS, Embedding, LayerNorm,
                                       Linear, RngStream, dropout, embedding,
                                       layer_norm, linear, next_seed,
                                       resolve_device)


@dataclasses.dataclass(frozen=True)
class MTConfig:
    vocab_size: int = 8000
    src_vocab_size: Optional[int] = None   # None -> joined dictionary (shared)
    embed_dim: int = 256
    ffn_dim: int = 2048
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 4
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "relu"
    share_all_embeddings: bool = True
    padding_idx: int = 1
    eos_idx: int = 2
    max_positions: int = 1024

    @property
    def decoder(self) -> tfm.DecoderConfig:
        return tfm.DecoderConfig(
            vocab_size=self.vocab_size, embed_dim=self.embed_dim,
            ffn_dim=self.ffn_dim, num_layers=self.decoder_layers,
            num_heads=self.num_heads, dropout=self.dropout,
            attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout,
            activation=self.activation, share_input_output_embed=True,
            padding_idx=self.padding_idx, eos_idx=self.eos_idx,
            encoder_embed_dim=self.embed_dim,
            max_target_positions=self.max_positions)


class TextEncoderLayer(nn.Module):
    def __init__(self, cfg: MTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, cfg.ffn_dim, generator=generator)
        self.fc2 = Linear(cfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)


class TextEncoder(nn.Module):
    def __init__(self, cfg: MTConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_tokens = Embedding(cfg.src_vocab_size or cfg.vocab_size,
                                      cfg.embed_dim, cfg.padding_idx,
                                      generator=generator)
        self.layers = nn.ModuleList(TextEncoderLayer(cfg, generator=generator)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(cfg.embed_dim)
        self.register_buffer(
            "pos_table",
            tfm.sinusoidal_table(cfg.max_positions + cfg.padding_idx + 1,
                                 cfg.embed_dim, cfg.padding_idx),
            persistent=False)


def text_encoder_forward(p: TextEncoder, cfg: MTConfig, tokens, *,
                         rngs: Optional[RngStream] = None):
    """tokens (B, S) -> (encoder_out (B, S, D), valid (B, S) bool)."""
    act = ACTIVATIONS[cfg.activation]
    valid = tokens != cfg.padding_idx
    positions = tfm.positions_from_tokens(tokens, cfg.padding_idx)
    x = math.sqrt(cfg.embed_dim) * embedding(p.embed_tokens, tokens)
    x = x + p.pos_table[positions].to(x.dtype)
    x = dropout(x, cfg.dropout, next_seed(rngs))
    for layer in p.layers:
        residual = x
        xh = layer_norm(layer.self_attn_ln, x)
        xh, _ = attn.mha_forward(layer.self_attn, xh, xh, xh, cfg.num_heads,
                                 key_valid=valid,
                                 dropout_rate=cfg.attention_dropout,
                                 seed=next_seed(rngs))
        x = residual + dropout(xh, cfg.dropout, next_seed(rngs))
        residual = x
        xh = layer_norm(layer.final_ln, x)
        xh = act(linear(layer.fc1, xh))
        xh = dropout(xh, cfg.activation_dropout, next_seed(rngs))
        xh = linear(layer.fc2, xh)
        x = residual + dropout(xh, cfg.dropout, next_seed(rngs))
    return layer_norm(p.layer_norm, x), valid


class MTTransformerModel(nn.Module):
    """Weights from a seeded CPU generator with the JAX package's init
    distributions, then moved to `device`, the card unless the caller names
    another; `compat/jax_bridge.py` loads JAX weights instead."""

    Config = MTConfig

    def __init__(self, cfg: MTConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = TextEncoder(cfg, generator=generator)
        self.decoder = tfm.Decoder(cfg.decoder, generator=generator,
                                   device="cpu")
        if cfg.share_all_embeddings:
            with torch.no_grad():
                self.decoder.embed_tokens.weight.copy_(
                    self.encoder.embed_tokens.weight)
        self.to(resolve_device(device))

    def forward(self, src_tokens, prev_tokens, *,
                rngs: Optional[RngStream] = None):
        """Teacher-forced forward; dropout when `rngs` is given (the JAX
        package's rng with deterministic=False).  Returns (logits (B, T, V),
        extra)."""
        enc, enc_valid = text_encoder_forward(self.encoder, self.cfg,
                                              src_tokens, rngs=rngs)
        logits = tfm.decoder_forward(self.decoder, self.cfg.decoder,
                                     prev_tokens, enc, enc_valid, rngs=rngs)
        return logits, {"encoder_out": enc, "encoder_valid": enc_valid}
