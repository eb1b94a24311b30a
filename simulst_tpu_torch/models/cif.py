"""CIF (Continuous Integrate-and-Fire) simultaneous translation model
(counterpart of simulst_tpu/models/cif.py).

An S2T Emformer encoder, a CIF layer (causal-conv alpha predictor and
`cif_function`) and a decoder whose cross-attention reads the fired CIF
features position by position (`fake_cross_attn`: out_proj(GELU(q_proj(x)
+ k_proj(cif)))) or, with cif_infinite_lookback, attends causally over
them; optionally the highway connection (the CIF feature added after the
final layer norm) and, at inference, the EOS overshoot bias.  On the card
the decoder's self-attention runs `fused_mha` with the `fused_linear_res`
epilogue, the fake cross-attention's out-projection and residual
`fused_linear_res`, the FFN `fused_ffn`, and the integration the CIF
kernel (ops/cif_integrate.py).  Parameter names are the JAX tree's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn import conv as cnv
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (LayerNorm, Linear, RngStream, cast,
                                       dropout, gelu, layer_norm, linear,
                                       next_seed, resolve_device)
from simulst_tpu_torch.ops.cif import CifOut, cif_function
from simulst_tpu_torch.ops.linear_res import fused_linear_res


@dataclasses.dataclass(frozen=True)
class CIFConfig(s2t.S2TEmformerConfig):
    cif_beta: float = 1.0
    cif_sg_alpha: bool = False
    cif_conv_kernel: int = 3
    cif_highway: bool = False
    cif_infinite_lookback: bool = False
    ctc_layer: bool = True   # arch cif_transformer_s forces the CTC head


# ---------------------------------------------------------------------------
# CIF layer (alpha predictor + integrate-and-fire)
# ---------------------------------------------------------------------------

class CIFLayer(nn.Module):
    def __init__(self, cfg: CIFConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        self.conv = cnv.CausalConv1d(d, d, cfg.cif_conv_kernel,
                                     generator=generator)
        self.ln = LayerNorm(d)
        self.proj = Linear(d, 1, generator=generator)


def _alpha_from_x(p: CIFLayer, cfg: CIFConfig, x, seed=None,
                  conv_cache: Optional[cnv.ConvCache] = None):
    """CausalConv -> LN -> GELU -> dropout -> Linear -> sigmoid: (B, S, D)
    -> (B, S), and the new conv cache when streaming."""
    h = x.detach() if cfg.cif_sg_alpha else x
    new_cache = None
    if conv_cache is None:
        h = cnv.causal_conv1d(p.conv, h)
    else:
        h, new_cache = cnv.causal_conv1d_step(p.conv, conv_cache, h)
    h = dropout(gelu(layer_norm(p.ln, h)), cfg.activation_dropout, seed)
    return torch.sigmoid(linear(p.proj, h)[..., 0]), new_cache


def cif_layer_forward(p: CIFLayer, cfg: CIFConfig, x, encoder_valid,
                      target_lengths=None, max_out_len: Optional[int] = None,
                      rngs: Optional[RngStream] = None
                      ) -> Tuple[CifOut, torch.Tensor]:
    """Offline and training CIF.  x: (B, S, D); encoder_valid: (B, S) bool.
    Returns (CifOut, alpha (B, S))."""
    alpha, _ = _alpha_from_x(p, cfg, x, next_seed(rngs))
    alpha = torch.where(encoder_valid, alpha, torch.zeros_like(alpha))
    xm = torch.where(encoder_valid[:, :, None], x, torch.zeros_like(x))
    if max_out_len is None:
        max_out_len = int(math.ceil(x.shape[1] / cfg.cif_beta)) + 2
    out = cif_function(xm, alpha, beta=cfg.cif_beta,
                       tail_thres=cfg.cif_beta / 2,
                       target_lengths=target_lengths, max_out_len=max_out_len)
    return out, alpha


class CIFStreamState(NamedTuple):
    conv: cnv.ConvCache
    prev_weight: torch.Tensor   # (B, 1) the carried tail's weight
    prev_feat: torch.Tensor     # (B, 1, D) its weighted average


def cif_layer_init_state(p: CIFLayer, cfg: CIFConfig, batch: int,
                         dtype=None, device=None) -> CIFStreamState:
    """`dtype` defaults to the config's compute dtype (prev_weight, a sum
    of alphas, stays fp32)."""
    dtype = cfg.dtype if dtype is None else dtype
    k = p.conv.weight.shape[-1]
    return CIFStreamState(
        conv=cnv.ConvCache(feat=torch.zeros(batch, k - 1, cfg.embed_dim,
                                            dtype=dtype, device=device)),
        prev_weight=torch.zeros(batch, 1, dtype=torch.float32, device=device),
        prev_feat=torch.zeros(batch, 1, cfg.embed_dim, dtype=dtype,
                              device=device))


def cif_layer_step(p: CIFLayer, cfg: CIFConfig, state: CIFStreamState, x,
                   finish: bool, x_valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, CIFStreamState]:
    """Streaming CIF on a chunk of new encoder frames x (B, c, D), c >= 0:
    the carried tail is prepended as one frame of its own weight.  Returns
    (fired (B, c + 3, D), n_emitted (B,), state): mid-stream the last,
    incomplete bucket is carried, not emitted; on finish everything is.
    x_valid: optional (B,) count of each example's valid frames in x (the
    final chunk of a batch whose utterances end at different offsets);
    the frames past it add zero alpha, as if absent."""
    b, c, d = x.shape
    alpha, conv_cache = _alpha_from_x(p, cfg, x, conv_cache=state.conv)
    if x_valid is not None:
        keep = torch.arange(c, device=x.device)[None, :] < \
            x_valid.to(x.device)[:, None]
        alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    a = torch.cat([state.prev_weight, alpha], dim=1)
    xx = torch.cat([state.prev_feat, x], dim=1)
    res = cif_function(xx, a, beta=cfg.cif_beta,
                       tail_thres=(cfg.cif_beta / 2) if finish else 0.0,
                       max_out_len=xx.shape[1] + 2)
    if finish:
        return res.cif_out, res.cif_lengths, CIFStreamState(
            conv=conv_cache, prev_weight=torch.zeros_like(state.prev_weight),
            prev_feat=torch.zeros_like(state.prev_feat))
    tail_idx = torch.clamp(res.cif_lengths - 1, 0, res.cif_out.shape[1] - 1)
    tail_feat = res.cif_out.gather(1, tail_idx[:, None, None].expand(b, 1, d))
    return res.cif_out, res.cif_lengths - 1, CIFStreamState(
        conv=conv_cache, prev_weight=res.tail_weights[:, None],
        prev_feat=tail_feat / cfg.cif_beta)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class FakeCrossAttn(nn.Module):
    """Position-aligned 'attention' over the CIF features; q_proj has no
    bias."""

    def __init__(self, cfg: CIFConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        gain = 1 / math.sqrt(2)
        self.q_proj = Linear(d, d, bias=False, init="xavier", gain=gain,
                             generator=generator)
        self.k_proj = Linear(d, d, init="xavier", gain=gain,
                             generator=generator)
        self.out_proj = Linear(d, d, init="xavier", generator=generator)


def _fake_hidden(p: FakeCrossAttn, query, key):
    return gelu(linear(p.q_proj, query) + linear(p.k_proj, key))


def fake_cross_attn(p: FakeCrossAttn, query, key):
    """out_proj(GELU(q_proj(query) + k_proj(key)))."""
    return linear(p.out_proj, _fake_hidden(p, query, key))


class CIFDecoderLayer(nn.Module):
    def __init__(self, cfg: CIFConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, dcfg = cfg.embed_dim, cfg.decoder
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        if cfg.cif_infinite_lookback:
            self.encoder_attn = attn.MultiheadAttention(d, kdim=d, vdim=d,
                                                        generator=generator)
        else:
            self.encoder_attn = FakeCrossAttn(cfg, generator=generator)
        self.encoder_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, dcfg.ffn_dim, generator=generator)
        self.fc2 = Linear(dcfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)


def cif_decoder_forward(p: tfm.Decoder, cfg: CIFConfig, prev_tokens,
                        cif_feats, cif_lengths, *,
                        rngs: Optional[RngStream] = None):
    """Teacher-forced forward: cif_feats (B, T', D) position-aligned with
    prev_tokens (B, T).  Dropout at the config's rates when rngs is given.
    Returns logits (B, T, V)."""
    dcfg = cfg.decoder
    positions = tfm.positions_from_tokens(prev_tokens, dcfg.padding_idx)
    x = tfm.decoder_embed(p, dcfg, prev_tokens, positions, rngs)
    self_valid = prev_tokens != dcfg.padding_idx
    t = prev_tokens.shape[1]
    cif = cif_feats[:, :t].to(x.dtype)
    for layer in p.layers:
        x = tfm._sublayer(layer.self_attn, layer.self_attn_ln, dcfg, x, None,
                          key_valid=self_valid, causal=True, rngs=rngs)
        if cfg.cif_infinite_lookback:
            # causal soft attention over the fired CIF features
            cif_valid = (torch.arange(t, device=x.device)[None, :]
                         < cif_lengths[:, None])
            x = tfm._sublayer(layer.encoder_attn, layer.encoder_attn_ln,
                              dcfg, x, cif, key_valid=cif_valid, causal=True,
                              rngs=rngs)
        else:
            ea = layer.encoder_attn
            h = _fake_hidden(ea, layer_norm(layer.encoder_attn_ln, x), cif)
            seed = next_seed(rngs)
            d = h.dtype
            x = fused_linear_res(h, cast(ea.out_proj.weight, d),
                                 cast(ea.out_proj.bias, d), x,
                                 rate=dcfg.dropout if seed is not None
                                 else 0.0, seed=seed or 0)
        x = tfm._ffn(layer, dcfg, x, rngs)
    x = layer_norm(p.layer_norm, x)
    if cfg.cif_highway:
        x = x + cif
    return tfm.output_layer(p, dcfg, x)


class CIFDecoderState(NamedTuple):
    caches: Tuple[attn.KVCache, ...]
    cross_caches: Tuple[attn.KVCache, ...]   # infinite lookback only
    step: torch.Tensor                       # (B,) tokens decoded so far


def cif_decoder_init_state(cfg: CIFConfig, batch: int, max_len: int,
                           dtype=None, device=None
                           ) -> CIFDecoderState:
    dcfg = cfg.decoder
    dtype = cfg.dtype if dtype is None else dtype
    hd = dcfg.embed_dim // dcfg.num_heads

    def caches():
        return tuple(attn.kv_cache_init(batch, dcfg.num_heads, max_len, hd,
                                        dtype, device)
                     for _ in range(dcfg.num_layers))

    return CIFDecoderState(caches=caches(), cross_caches=caches(),
                           step=torch.zeros(batch, dtype=torch.int64,
                                            device=device))


def cif_decoder_step(p: tfm.Decoder, cfg: CIFConfig, state: CIFDecoderState,
                     token, cif_buf, cif_len, overshoot_weight: float = 1.0):
    """One decode step (no dropout).  cif_buf: (B, Tmax, D) fired features,
    cif_len (B,) of them valid; the step reads the feature at min(cif_len,
    step + 1) - 1 and adds overshoot_weight x max(step + 1 - cif_len, 0) to
    EOS's logit.  The KV caches are appended in place, with new counts in
    the returned state (nn/attention.kv_cache_append), so keeping the old
    state rolls the step back.  Returns (logits (B, V), state)."""
    dcfg = cfg.decoder
    b = token.shape[0]
    pos = dcfg.padding_idx + 1 + state.step
    x = tfm.decoder_embed(p, dcfg, token[:, None], pos[:, None])

    t1 = state.step + 1
    cif_idx = torch.clamp(torch.minimum(cif_len, t1) - 1, 0,
                          cif_buf.shape[1] - 1)
    cif_t = cif_buf.gather(1, cif_idx[:, None, None].expand(
        b, 1, cif_buf.shape[2])).to(x.dtype)

    new_caches, new_cross = [], []
    for layer, cache, xcache in zip(p.layers, state.caches,
                                    state.cross_caches):
        xh, cache = attn.mha_step(layer.self_attn, cache,
                                  layer_norm(layer.self_attn_ln, x),
                                  dcfg.num_heads)
        x = x + xh
        xh = layer_norm(layer.encoder_attn_ln, x)
        ea = layer.encoder_attn
        if cfg.cif_infinite_lookback:
            # append this step's CIF feature to the cross cache, attend the
            # prefix
            h = dcfg.num_heads
            xcache = attn.kv_cache_append(
                xcache, attn._split_heads(linear(ea.k_proj, cif_t), h),
                attn._split_heads(linear(ea.v_proj, cif_t), h))
            q = attn._split_heads(linear(ea.q_proj, xh), h)
            valid = (torch.arange(xcache.k.shape[2], device=x.device)[None, :]
                     < xcache.length[:, None])
            out, _ = attn.attend(q, xcache.k.to(q.dtype), xcache.v.to(q.dtype),
                                 key_valid=valid)
            xh = linear(ea.out_proj, attn._merge_heads(out))
        else:
            xh = fake_cross_attn(ea, xh, cif_t)
        x = tfm._ffn(layer, dcfg, x + xh)
        new_caches.append(cache)
        new_cross.append(xcache)

    x = layer_norm(p.layer_norm, x)
    if cfg.cif_highway:
        x = x + cif_t
    logits = tfm.output_layer(p, dcfg, x)[:, 0]
    overshoot = torch.clamp(t1 - cif_len, min=0).to(logits.dtype)
    eos = torch.zeros_like(logits)
    eos[:, dcfg.eos_idx] = overshoot * overshoot_weight
    return logits + eos, CIFDecoderState(caches=tuple(new_caches),
                                         cross_caches=tuple(new_cross),
                                         step=t1)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class CIFModel(nn.Module):
    """Encoder, CIF layer and CIF decoder.  Weights from a seeded CPU
    generator, then moved to `device`, the card unless the caller names
    another; compat/jax_bridge.load_jax_params loads a JAX tree instead."""

    def __init__(self, cfg: CIFConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = s2t.S2TEmformerEncoder(cfg, generator=generator,
                                              device=device)
        self.cif = CIFLayer(cfg, generator=generator).to(
            resolve_device(device))
        self.decoder = tfm.Decoder(
            cfg.decoder, generator=generator, device=device,
            make_layer=lambda: CIFDecoderLayer(cfg, generator=generator))

    def forward(self, feats, feat_lengths, prev_tokens, *,
                rngs: Optional[RngStream] = None):
        """Teacher-forced forward with the CIF lengths forced to the
        targets' (the non-pad count of prev_tokens); dropout when `rngs` is
        given.  Returns (logits (B, T, V), extra)."""
        cfg = self.cfg
        enc = s2t.encoder_forward(self.encoder, cfg, feats, feat_lengths,
                                  rngs)
        valid = (torch.arange(enc.encoder_out.shape[1],
                              device=feats.device)[None, :]
                 < enc.lengths[:, None])
        target_lengths = (prev_tokens != cfg.padding_idx).sum(dim=1)
        cif_out, alpha = cif_layer_forward(
            self.cif, cfg, enc.encoder_out, valid,
            target_lengths=target_lengths, max_out_len=prev_tokens.shape[1],
            rngs=rngs)
        logits = cif_decoder_forward(self.decoder, cfg, prev_tokens,
                                     cif_out.cif_out, cif_out.cif_lengths,
                                     rngs=rngs)
        return logits, {"ctc_logits": enc.ctc_logits,
                        "encoder_lengths": enc.lengths,
                        "alpha": alpha, "delays": cif_out.delays,
                        "cif_lengths": cif_out.cif_lengths}
