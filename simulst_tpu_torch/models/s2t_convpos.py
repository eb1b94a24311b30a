"""s2t_transformer_convpos: the offline S2T transformer with a non-causal
convolutional positional embedding, the ASR architecture before the
Emformer (counterpart of simulst_tpu/models/s2t_convpos.py).

The causal conv subsampler, then the weight-normed grouped conv-pos over
the full `conv_pos` taps with SAME padding (k // 2 each side, the last
column dropped for an even kernel: fairseq's SamePad) and GELU, then a
pre-LN transformer encoder with bidirectional self-attention over the
valid frames (`nn/attention.mha_forward`: the fused_mha kernel with the key
mask, not causal), a plain linear -> activation -> linear FFN and a final
layer norm, and the s2t_emformer decoder.  The conv-pos is one grouped
`F.conv1d`, as the JAX package computes it with its plain conv (the
conv-pos weight-gradient kernel serves the causal conv-pos only).  No CTC
head: a joint-CTC loss trains the CE alone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from simulst_tpu_torch.models.s2t_emformer import (EncoderOut,
                                                   S2TEmformerConfig)
from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn import conv as cnv
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (ACTIVATIONS, LayerNorm, Linear,
                                       RngStream, cast, dropout, gelu,
                                       layer_norm, lengths_to_mask, linear,
                                       next_seed, resolve_device)


@dataclasses.dataclass(frozen=True)
class S2TConvPosConfig(S2TEmformerConfig):
    """s2t_emformer_s's widths; the Emformer geometry and ctc_layer are
    unused."""


class EncoderLayer(nn.Module):
    def __init__(self, cfg: S2TConvPosConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, cfg.ffn_dim, generator=generator)
        self.fc2 = Linear(cfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)


class S2TConvPosEncoder(nn.Module):
    """Weights from a seeded CPU generator, then moved to `device` (the card
    unless the caller names another)."""

    def __init__(self, cfg: S2TConvPosConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.subsample = cnv.Subsampler(cfg.input_feat, cfg.conv_channels,
                                        cfg.embed_dim, cfg.conv_kernel_sizes,
                                        generator=generator)
        self.conv_pos = cnv.ConvPos(cfg.embed_dim, cfg.conv_pos,
                                    cfg.conv_pos_groups, kernel=cfg.conv_pos,
                                    generator=generator)
        self.layers = nn.ModuleList(EncoderLayer(cfg, generator=generator)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = LayerNorm(cfg.embed_dim)
        self.to(resolve_device(device))


def conv_pos_noncausal(p: cnv.ConvPos, x, groups: int):
    """x: (B, T, D) -> GELU(SamePad(conv(x))) (B, T, D)."""
    w = cnv._conv_pos_weight(p).to(x.dtype)
    k = w.shape[-1]
    y = cnv._conv1d(F.pad(x, (0, 0, k // 2, k // 2)), w, 1, groups)
    y = y + cast(p.bias, x.dtype)
    if k % 2 == 0:
        y = y[:, :-1]
    return gelu(y)


def encoder_forward(p: S2TConvPosEncoder, cfg: S2TConvPosConfig, feats,
                    feat_lengths, rngs: Optional[RngStream] = None
                    ) -> EncoderOut:
    """Offline / training forward. feats: (B, T, F); feat_lengths: (B,).
    Dropout at the config's rates when rngs is given.  The features are
    cast to the compute dtype, as s2t_emformer's are (the JAX package casts
    only s2t_emformer's and lets its bf16 decoder promote against an fp32
    encoder output; the port's attention takes one dtype)."""
    x, lengths = cnv.subsampler_apply(p.subsample, feats.to(cfg.dtype),
                                      feat_lengths)
    x = cfg.embed_scale * x
    x = x + conv_pos_noncausal(p.conv_pos, x, cfg.conv_pos_groups)
    x = dropout(x, cfg.dropout, next_seed(rngs))
    valid = lengths_to_mask(lengths, x.shape[1])
    act = ACTIVATIONS[cfg.activation]
    for layer in p.layers:
        h = layer_norm(layer.self_attn_ln, x)
        h, _ = attn.mha_forward(layer.self_attn, h, h, h, cfg.encoder_heads,
                                key_valid=valid,
                                dropout_rate=cfg.attention_dropout,
                                seed=next_seed(rngs))
        x = x + dropout(h, cfg.dropout, next_seed(rngs))
        h = act(linear(layer.fc1, layer_norm(layer.final_ln, x)))
        h = linear(layer.fc2, dropout(h, cfg.activation_dropout,
                                      next_seed(rngs)))
        x = x + dropout(h, cfg.dropout, next_seed(rngs))
    x = layer_norm(p.layer_norm, x)
    return EncoderOut(encoder_out=x, lengths=lengths, ctc_logits=None)


class S2TConvPosModel(nn.Module):
    """Encoder-decoder ASR / ST model; weights from a seeded generator on
    `device`, the card unless the caller names another."""

    def __init__(self, cfg: S2TConvPosConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = S2TConvPosEncoder(cfg, generator=generator,
                                         device=device)
        self.decoder = tfm.Decoder(cfg.decoder, generator=generator,
                                   device=device)

    def forward(self, feats, feat_lengths, prev_tokens, *,
                rngs: Optional[RngStream] = None):
        """Teacher-forced forward; dropout when `rngs` is given.  Returns
        (logits (B, T, V), extra)."""
        enc = encoder_forward(self.encoder, self.cfg, feats, feat_lengths,
                              rngs)
        enc_valid = lengths_to_mask(enc.lengths, enc.encoder_out.shape[1])
        logits = tfm.decoder_forward(self.decoder, self.cfg.decoder,
                                     prev_tokens, enc.encoder_out, enc_valid,
                                     rngs=rngs)
        return logits, {"ctc_logits": None, "encoder_lengths": enc.lengths,
                        "encoder_out": enc.encoder_out}
