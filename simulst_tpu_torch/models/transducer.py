"""Transformer-Transducer (counterpart of simulst_tpu/models/transducer.py).

The S2T Emformer encoder, a label encoder (a Transformer decoder stack
without cross-attention, depth-scaled at init) and a joiner that builds
the (B, S, U + 1, V) lattice tanh(source_projection(src) + tgt @ W) @ E^T,
E the shared token embedding.  Optional length-aware average pooling of
the encoder frames (`downsample`, the last pooled frame rescaled).
Training: `TransducerModel.forward` rewrites the label sequence to [bos,
y.., eos] (bos == blank == 0) and returns the lattice for the RNN-T
criterion (losses/rnnt_loss.py).  Inference: `decode_step` runs one label
step over the visible source frames and picks the first frame at or past
the last emit whose greedy prediction is not blank; offline (online=False)
it forces an emit at the last frame, online an all-blank prefix is the
streaming agent's READ.

On the card the label encoder runs its self-attention core through
`fused_mha`, the out-projection epilogue through `fused_linear_res` and its
FFN through `fused_ffn`; `decode_step` attends through the plain
`mha_step` and runs the FFN kernel, as the JAX package does.  The joiner
and the lattice are plain torch.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (Embedding, LayerNorm, Linear,
                                       RngStream, cast, layer_norm, linear,
                                       resolve_device)


@dataclasses.dataclass(frozen=True)
class TransducerConfig(s2t.S2TEmformerConfig):
    downsample: int = 1
    blank_idx: int = 0  # == bos


def _depth_scale(cfg: TransducerConfig) -> float:
    """The reference's init scale of the label encoder's embedding, FFN,
    value and output projections: (3 * 2 * layers) ** -0.25."""
    return (3 * 2 * cfg.decoder_layers) ** -0.25


class LabelEncoderLayer(nn.Module):
    """A decoder layer without cross-attention; the parameter names are the
    JAX tree's."""

    def __init__(self, cfg: TransducerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, dcfg = cfg.embed_dim, cfg.decoder
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, dcfg.ffn_dim, generator=generator)
        self.fc2 = Linear(dcfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)
        scale = _depth_scale(cfg)
        with torch.no_grad():
            for w in (self.fc1.weight, self.fc2.weight,
                      self.self_attn.v_proj.weight,
                      self.self_attn.out_proj.weight):
                w.mul_(scale)


class Joiner(nn.Module):
    """source_projection (with bias) and target_projection (a weight, used
    as tgt @ W), xavier-initialised with the reference's depth gains."""

    def __init__(self, cfg: TransducerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.source_projection = Linear(
            d, d, init="xavier", gain=(cfg.encoder_layers + 1) ** -0.5,
            generator=generator)
        self.target_projection = Linear(
            d, d, bias=False, init="xavier",
            gain=(cfg.decoder_layers + 1) ** -0.5, generator=generator)


class TransducerDecoder(nn.Module):
    """The label encoder and the joiner; the output layer is the shared
    token embedding."""

    def __init__(self, cfg: TransducerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dcfg = cfg.decoder
        self.embed_tokens = Embedding(dcfg.vocab_size, dcfg.embed_dim,
                                      dcfg.padding_idx, generator=generator)
        with torch.no_grad():
            self.embed_tokens.weight.mul_(_depth_scale(cfg))
        self.layers = nn.ModuleList(LabelEncoderLayer(cfg,
                                                      generator=generator)
                                    for _ in range(dcfg.num_layers))
        self.layer_norm = LayerNorm(dcfg.embed_dim)
        self.joiner = Joiner(cfg, generator=generator)
        self.register_buffer(
            "pos_table",
            tfm.sinusoidal_table(dcfg.max_target_positions
                                 + dcfg.padding_idx + 1, dcfg.embed_dim,
                                 dcfg.padding_idx),
            persistent=False)


def label_features(p: TransducerDecoder, cfg: TransducerConfig, tokens,
                   rngs: Optional[RngStream] = None):
    """Teacher-forced label encoder over tokens (B, U): (B, U, D) after the
    final layer norm; dropout when rngs is given."""
    dcfg = cfg.decoder
    positions = tfm.positions_from_tokens(tokens, dcfg.padding_idx)
    x = tfm.decoder_embed(p, dcfg, tokens, positions, rngs)
    valid = tokens != dcfg.padding_idx
    for layer in p.layers:
        x = tfm._sublayer(layer.self_attn, layer.self_attn_ln, dcfg, x, None,
                          key_valid=valid, causal=True, rngs=rngs)
        x = tfm._ffn(layer, dcfg, x, rngs)
    return layer_norm(p.layer_norm, x)


def joiner_forward(p: TransducerDecoder, src_feats, tgt_feats):
    """(B, S, D) x (B, U, D) -> (B, S, U, V) logits."""
    s = linear(p.joiner.source_projection, src_feats)[:, :, None, :]
    t = tgt_feats @ cast(p.joiner.target_projection.weight, tgt_feats.dtype)
    join = torch.tanh(s + t[:, None, :, :])
    return join @ cast(p.embed_tokens.weight, join.dtype).T


def downsample_pool(x, lengths, k: int):
    """Length-aware ceil-mode average pooling over k frames, x: (B, T, C).
    Frames past each example's length count as zeros, and its last pooled
    frame, the mean of its r = (len - 1) % k + 1 real frames, is rescaled
    by k / r.  Returns (pooled (B, ceil(T / k), C), ceil(lengths / k))."""
    if k <= 1:
        return x, lengths
    b, t, c = x.shape
    ar = torch.arange(t, device=x.device)
    x = torch.where((ar[None, :] < lengths[:, None])[:, :, None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    n = -(-t // k)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n * k - t))
    # the window's sum times 1 / k: XLA's mean, to the bit
    pooled = xp.reshape(b, n, k, c).sum(dim=2) * (1.0 / k)
    r = (lengths - 1) % k + 1
    last = (lengths - r) // k
    scale = (k / r.float()).to(x.dtype)
    onehot = torch.arange(n, device=x.device)[None, :] == last[:, None]
    pooled = pooled * torch.where(onehot, scale[:, None],
                                  torch.ones((), dtype=x.dtype,
                                             device=x.device))[:, :, None]
    return pooled, -(-lengths // k)


class TransducerState(NamedTuple):
    caches: Tuple[attn.KVCache, ...]
    prev_emit: torch.Tensor  # (B,) int64: the last emitted source frame
    step: torch.Tensor       # (B,) int64: labels consumed so far


def init_decode_state(cfg: TransducerConfig, batch: int, max_len: int,
                      dtype=None, device=None) -> TransducerState:
    dcfg = cfg.decoder
    dtype = cfg.dtype if dtype is None else dtype
    hd = dcfg.embed_dim // dcfg.num_heads
    zeros = torch.zeros(batch, dtype=torch.int64, device=device)
    return TransducerState(
        caches=tuple(attn.kv_cache_init(batch, dcfg.num_heads, max_len, hd,
                                        dtype, device)
                     for _ in range(dcfg.num_layers)),
        prev_emit=zeros, step=zeros.clone())


def decode_step(p: TransducerDecoder, cfg: TransducerConfig,
                state: TransducerState, token, src_buf, src_len,
                online: bool = False):
    """One label step over the visible source prefix.  token (B,): the
    previous label (blank at the start); src_buf (B, S, D) raw encoder
    frames, src_len (B,) how many are visible (pooled here when downsample
    > 1, so that prev_emit and the emit positions are pooled frames; the
    last partial window is recomputed as the source grows).  Returns
    (logits (B, V) at the chosen frame, emitted (B,) bool, the attempted
    state).  The KV caches are appended in place with new counts, so
    keeping the old state discards the attempt.

    Offline the blank is barred at the last visible frame, so every
    example emits; online an all-blank prefix (emitted False) is a READ.
    Frames past the source or before prev_emit are exact one-hot blank
    rows, and the chosen frame is the first non-blank one."""
    dcfg = cfg.decoder
    if cfg.downsample > 1:
        src_buf, src_len = downsample_pool(src_buf, src_len, cfg.downsample)
    s_max = src_buf.shape[1]
    pos = dcfg.padding_idx + 1 + state.step
    x = tfm.decoder_embed(p, dcfg, token[:, None], pos[:, None])
    caches = []
    for layer, cache in zip(p.layers, state.caches):
        xh, cache = attn.mha_step(layer.self_attn, cache,
                                  layer_norm(layer.self_attn_ln, x),
                                  dcfg.num_heads)
        x = tfm._ffn(layer, dcfg, x + xh)
        caches.append(cache)
    tgt = layer_norm(p.layer_norm, x)                          # (B, 1, D)
    lattice = joiner_forward(p, src_buf, tgt)[:, :, 0, :]      # (B, S, V)
    v, bos = lattice.shape[-1], cfg.blank_idx
    frames = torch.arange(s_max, device=lattice.device)[None, :]
    if not online:
        at_eos = (frames == (src_len - 1)[:, None])[:, :, None] & \
            (torch.arange(v, device=lattice.device) == bos)
        lattice = torch.where(at_eos, torch.full((), -1e4,
                                                 dtype=lattice.dtype,
                                                 device=lattice.device),
                              lattice)
    invalid = (frames >= src_len[:, None]) | \
        (frames < state.prev_emit[:, None])
    blank_row = torch.nn.functional.one_hot(
        torch.tensor(bos, device=lattice.device), v).to(lattice.dtype)
    lattice = torch.where(invalid[:, :, None], blank_row, lattice)
    nonblank = lattice.argmax(dim=-1) != bos                   # (B, S)
    emitted = nonblank.any(dim=1)
    first = torch.argmax((torch.cumsum(nonblank.long(), dim=1) == 1).long(),
                         dim=1)
    new_emit = torch.where(emitted, first, state.prev_emit)
    logits = lattice.gather(1, new_emit[:, None, None].expand(-1, 1, v))[:, 0]
    return logits, emitted, TransducerState(caches=tuple(caches),
                                            prev_emit=new_emit,
                                            step=state.step + 1)


class TransducerModel(nn.Module):
    """Encoder, label encoder and joiner.  Weights from a seeded CPU
    generator, then moved to `device`, the card unless the caller names
    another; compat/jax_bridge.load_jax_params loads a JAX tree instead."""

    def __init__(self, cfg: TransducerConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = s2t.S2TEmformerEncoder(cfg, generator=generator,
                                              device=device)
        self.decoder = TransducerDecoder(cfg, generator=generator)
        self.decoder.to(resolve_device(device))

    def forward(self, feats, feat_lengths, prev_tokens, *,
                rngs: Optional[RngStream] = None):
        """Teacher-forced lattice; dropout when `rngs` is given.
        prev_tokens: the target with EOS moved to the front, right-padded;
        the label sequence becomes [bos, y.., eos] (the front EOS replaced
        by bos, EOS appended after the last token).  Returns (logits (B, S,
        U + 1, V), extra)."""
        cfg = self.cfg
        enc = s2t.encoder_forward(self.encoder, cfg, feats, feat_lengths,
                                  rngs)
        src, src_lens = downsample_pool(enc.encoder_out, enc.lengths,
                                        cfg.downsample)
        toks = torch.nn.functional.pad(prev_tokens.long(), (0, 1),
                                       value=cfg.padding_idx)
        toks[:, 0] = cfg.blank_idx
        tl = (toks != cfg.padding_idx).sum(dim=1)
        at_end = torch.arange(toks.shape[1], device=toks.device)[None, :] \
            == tl[:, None]
        toks = torch.where(at_end, torch.full_like(toks, cfg.eos_idx), toks)
        tgt = label_features(self.decoder, cfg, toks, rngs)
        return joiner_forward(self.decoder, src, tgt), {
            "encoder_lengths": src_lens, "label_tokens": toks,
            "label_lengths": tl + 1, "ctc_logits": enc.ctc_logits}
