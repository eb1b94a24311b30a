"""Monotonic Multihead Attention (MMA) model (counterpart of
simulst_tpu/models/mma.py).

An S2T Emformer encoder and a Transformer decoder whose cross-attention is
monotonic.  Training: p_choose -> the expected alignment (the recursion's
kernels, ops/monotonic.py) -> mass preservation -> expected soft attention
(MILk, MoChA) or the hard alpha, one batched pass per layer; with fixed
pre-decision the alignment runs at the pooled resolution ceil(S / r) and
is upsampled by inserting zeros.  Inference: `mma_decoder_step` runs every
layer and reports READ when any head of any layer demands more source; on
READ the caller keeps the old KV caches and step and adopts only the
advanced monotonic head positions (`adopt_on_read`).  The KV caches are
written in place, but each step returns new fill counts
(nn/attention.kv_cache_append), so keeping the old state rolls a step
back, per example when selected per example.

Variants: hard_aligned, infinite_lookback, waitk and chunkwise, each with
and without the fixed pre-decision pooling (`_fixed_pre_decision`).  The
decoder's self-attention and FFN and the out-projection epilogue of both
attentions run the port's kernels (fused_mha, fused_linear_res,
fused_ffn); the monotonic attention's own math is plain torch around the
alignment kernels.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.nn import attention as attn
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (LayerNorm, Linear, RngStream, cast,
                                       layer_norm, linear, neg_inf,
                                       next_seed)
from simulst_tpu_torch.ops import monotonic as mono
from simulst_tpu_torch.ops.linear_res import fused_linear_res


@dataclasses.dataclass(frozen=True)
class MMAConfig(s2t.S2TEmformerConfig):
    simul_attn_type: str = "waitk_fixed_pre_decision"
    waitk_lagging: int = 3
    waitk_testtime: Optional[int] = None
    noise_var: float = 2.0
    noise_mean: float = 0.0
    energy_bias: bool = False
    energy_bias_init: float = -2.0
    attention_eps: float = 1e-6
    mass_preservation: bool = True
    fixed_pre_decision_ratio: int = 8
    fixed_pre_decision_type: str = "average"
    fixed_pre_decision_pad_threshold: float = 0.3
    mocha_chunk_size: Optional[int] = None

    @property
    def base_attn_type(self) -> str:
        return self.simul_attn_type.replace("_fixed_pre_decision", "")

    @property
    def pooled(self) -> bool:
        return self.simul_attn_type.endswith("_fixed_pre_decision")

    @property
    def soft_attention(self) -> bool:
        return self.base_attn_type in ("infinite_lookback", "waitk",
                                       "chunkwise")


# ---------------------------------------------------------------------------
# monotonic attention module
# ---------------------------------------------------------------------------

class MonotonicAttention(nn.Module):
    """fairseq MultiheadAttention-style projections; separate soft-energy
    projections for infinite_lookback and chunkwise (waitk ties the soft
    energy to the monotonic one)."""

    def __init__(self, cfg: MMAConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d = cfg.embed_dim
        gain = 1 / math.sqrt(2)

        def proj(g=gain):
            return Linear(d, d, init="xavier", gain=g, generator=generator)

        self.q_proj, self.k_proj, self.v_proj = proj(), proj(), proj()
        self.out_proj = proj(1.0)
        soft = cfg.base_attn_type in ("infinite_lookback", "chunkwise")
        self.q_proj_soft = proj() if soft else None
        self.k_proj_soft = proj() if soft else None
        if cfg.energy_bias:
            self.energy_bias = nn.Parameter(
                torch.full((1,), cfg.energy_bias_init))
        else:
            self.register_parameter("energy_bias", None)


def _split(x, h: int):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _energy(p: MonotonicAttention, cfg: MMAConfig, query, key, which: str,
            key_padding_mask=None, add_bias: bool = False):
    """(B, H, Tq, Tk) scaled dot-product energies."""
    h = cfg.decoder_heads
    soft = which == "soft"
    qp = p.q_proj_soft if soft and p.q_proj_soft is not None else p.q_proj
    kp = p.k_proj_soft if soft and p.k_proj_soft is not None else p.k_proj
    hd = cfg.embed_dim // h
    q = _split(linear(qp, query), h) * (hd ** -0.5)
    k = _split(linear(kp, key), h)
    e = q @ k.transpose(-1, -2)
    if add_bias and p.energy_bias is not None:
        e = e + p.energy_bias.to(e.dtype)[0]
    if key_padding_mask is not None:
        e = e.masked_fill(key_padding_mask[:, None, None, :], neg_inf(e.dtype))
    return e


def _pool_keys(cfg: MMAConfig, key, src_len):
    """Fixed pre-decision pooling, key (B, S, D) -> (B, ceil(S / r), D):
    ceil-mode average over windows of r frames, divided by the window's
    size (the shorter tail by its own), with the frames beyond src_len
    zeroed first."""
    r = cfg.fixed_pre_decision_ratio
    b, s, d = key.shape
    n = -(-s // r)
    kp = F.pad(key, (0, 0, 0, n * r - s))
    valid = (torch.arange(n * r, device=key.device)[None, :]
             < src_len[:, None]).to(key.dtype)
    sums = (kp * valid[:, :, None]).reshape(b, n, r, d).sum(dim=2)
    start = torch.arange(n, device=key.device) * r
    cnt_window = torch.clamp(start + r, max=min(s, n * r)) - start
    return sums / torch.clamp(cnt_window, min=1)[None, :, None].to(key.dtype)


def _pool_padding_mask(cfg: MMAConfig, key_padding_mask):
    """A pooled position is padding iff more than the threshold of its
    window is; position 0 is always valid."""
    r = cfg.fixed_pre_decision_ratio
    b, s = key_padding_mask.shape
    n = -(-s // r)
    m = F.pad(key_padding_mask.float(), (0, n * r - s), value=1.0)
    start = torch.arange(n, device=m.device) * r
    sizes = torch.clamp(start + r, max=s) - start
    frac = m.reshape(b, n, r).sum(2) / torch.clamp(sizes, min=1)[None, :]
    pooled = frac > cfg.fixed_pre_decision_pad_threshold
    pooled[:, 0] = False
    return pooled


def _upsample_p_choose(p_choose_pooled, r: int, src_len_static: int):
    """Insert zeros: pooled value k lands on frame (k + 1) r - 1, the last
    of its block; then pad with zeros, or truncate to src_len_static with
    the final pooled value pinned on the last frame."""
    b, h, tq, n_p = p_choose_pooled.shape
    zeros = p_choose_pooled.new_zeros(b, h, tq, n_p, r - 1)
    up = torch.cat([zeros, p_choose_pooled[..., None]], dim=-1).reshape(
        b, h, tq, n_p * r)
    if n_p * r < src_len_static:
        return F.pad(up, (0, src_len_static - n_p * r))
    return torch.cat([up[..., :src_len_static - 1],
                      p_choose_pooled[..., -1:]], dim=-1)


def mma_p_choose_train(p: MonotonicAttention, cfg: MMAConfig, query, key,
                       key_padding_mask, generator=None,
                       return_pooled: bool = False):
    """Training p_choose (B, H, Tq, S), pooled if fixed pre-decision;
    return_pooled skips the upsampling and returns (B, H, Tq, ceil(S / r)).
    The learnable variants add noise drawn from `generator` when given."""
    b, tq = query.shape[0], query.shape[1]
    s = key.shape[1]
    h = cfg.decoder_heads
    if cfg.pooled:
        src_len = ((~key_padding_mask).sum(-1) if key_padding_mask is not None
                   else torch.full((b,), s, device=key.device))
        key_p = _pool_keys(cfg, key, src_len)
        kpm_p = (_pool_padding_mask(cfg, key_padding_mask)
                 if key_padding_mask is not None else None)
    else:
        key_p, kpm_p = key, key_padding_mask

    if cfg.base_attn_type == "waitk":
        pc = mono.waitk_p_choose(tq, key_p.shape[1], b, cfg.waitk_lagging,
                                 kpm_p, online=False, device=key.device)
        pc = pc[:, None].expand(b, h, tq, key_p.shape[1])
    else:
        energy = _energy(p, cfg, query, key_p, "monotonic", kpm_p,
                         add_bias=True)
        pc = mono.learnable_p_choose(energy, cfg.noise_mean,
                                     math.sqrt(cfg.noise_var), generator)
    if cfg.pooled and not return_pooled:
        pc = _upsample_p_choose(pc, cfg.fixed_pre_decision_ratio, s)
    return pc


def mma_attention_forward(p: MonotonicAttention, cfg: MMAConfig, query, key,
                          value, key_padding_mask=None, *,
                          generator: Optional[torch.Generator] = None,
                          epilogue=None):
    """Training forward.  query: (B, Tq, D); key / value: (B, S, De).
    epilogue: optional (res, rate, seed): return res + dropout(out_proj(.))
    from one fused_linear_res pass.  Returns (out (B, Tq, D), dict of
    p_choose, alpha, beta, each (B, H, Tq, S))."""
    b, tq, d = query.shape
    s = key.shape[1]
    h = cfg.decoder_heads
    kpm_flat = (key_padding_mask.repeat_interleave(h, dim=0)
                if key_padding_mask is not None else None)
    if cfg.pooled:
        # the alignment at the pooled resolution: the upsampled p_choose is
        # zero but on every r-th frame, and zeros ride the recursion as
        # identities, so the DP runs at ceil(S / r) and alpha is upsampled
        r = cfg.fixed_pre_decision_ratio
        pc_pool = mma_p_choose_train(p, cfg, query, key, key_padding_mask,
                                     generator, return_pooled=True)
        n_p = pc_pool.shape[-1]
        land_kpm = None
        if key_padding_mask is not None:
            # the frame each pooled value lands on, masked as the full
            # resolution key_padding_mask would mask it
            src_len = (~key_padding_mask).sum(-1)
            land = torch.clamp(
                torch.arange(1, n_p + 1, device=key.device) * r - 1,
                max=s - 1)
            land_kpm = (land[None, :] >= src_len[:, None]).repeat_interleave(
                h, dim=0)
        alpha_p = mono.expected_alignment_from_p_choose(
            pc_pool.reshape(b * h, tq, n_p), land_kpm, eps=cfg.attention_eps)
        alpha = _upsample_p_choose(alpha_p.reshape(b, h, tq, n_p), r, s
                                   ).reshape(b * h, tq, s)
        pc = _upsample_p_choose(pc_pool, r, s)
    else:
        pc = mma_p_choose_train(p, cfg, query, key, key_padding_mask,
                                generator)
        alpha = mono.expected_alignment_from_p_choose(
            pc.reshape(b * h, tq, s), kpm_flat, eps=cfg.attention_eps)
    if cfg.mass_preservation:
        alpha = mono.mass_preservation(alpha, kpm_flat)

    if cfg.soft_attention:
        soft_e = _energy(p, cfg, query, key, "soft", None).reshape(b * h, tq,
                                                                   s)
        beta = mono.expected_soft_attention(alpha, soft_e, kpm_flat,
                                            chunk_size=cfg.mocha_chunk_size,
                                            eps=cfg.attention_eps)
    else:
        beta = alpha

    v = _split(linear(p.v_proj, value), h)                    # (B, H, S, hd)
    beta_h = beta.reshape(b, h, tq, s)
    out = (beta_h.to(v.dtype) @ v).transpose(1, 2).reshape(b, tq, d)
    if epilogue is not None:
        res, rate, seed = epilogue
        y = fused_linear_res(out, cast(p.out_proj.weight, out.dtype),
                             cast(p.out_proj.bias, out.dtype),
                             res.to(out.dtype),
                             rate=rate if seed is not None else 0.0,
                             seed=seed or 0)
    else:
        y = linear(p.out_proj, out)
    return y, {"p_choose": pc, "alpha": alpha.reshape(b, h, tq, s),
               "beta": beta_h}


# ---------------------------------------------------------------------------
# inference step
# ---------------------------------------------------------------------------

class MonotonicState(NamedTuple):
    head_step: torch.Tensor  # (B, H) int32: source position of each head
    head_read: torch.Tensor  # (B, H) bool: the head demands more source


def monotonic_init_state(batch: int, num_heads: int,
                         device=None) -> MonotonicState:
    return MonotonicState(
        head_step=torch.zeros(batch, num_heads, dtype=torch.int32,
                              device=device),
        head_read=torch.zeros(batch, num_heads, dtype=torch.bool,
                              device=device))


def mma_attention_step(p: MonotonicAttention, cfg: MMAConfig,
                       state: MonotonicState, query_step, key_buf, value_buf,
                       src_len, tgt_step, online: bool):
    """One incremental cross-attention step.  query_step: (B, 1, D);
    key_buf / value_buf: (B, S_max, De) with src_len (B,) valid frames;
    tgt_step: (B,) target tokens consumed including this one (1-based), for
    wait-k; online: the encoder is still growing.  Returns (out (B, 1, D),
    state)."""
    b, _, d = query_step.shape
    h = cfg.decoder_heads
    s_max = key_buf.shape[1]
    r = cfg.fixed_pre_decision_ratio if cfg.pooled else 1
    dev = key_buf.device

    # p_choose on the (pooled) keys
    if cfg.pooled:
        key_p = _pool_keys(cfg, key_buf, src_len)
        n_pool = torch.clamp(src_len // r, min=1)   # floor at inference
        kpm_p = torch.arange(key_p.shape[1], device=dev)[None, :] \
            >= n_pool[:, None]
    else:
        key_p = key_buf
        n_pool = src_len
        kpm_p = torch.arange(s_max, device=dev)[None, :] >= src_len[:, None]

    if cfg.base_attn_type == "waitk":
        kk = cfg.waitk_testtime or cfg.waitk_lagging
        step_pos = tgt_step - 1 + (kk - 1)                  # pooled index
        pos = step_pos if online else torch.minimum(step_pos, n_pool - 1)
        # online, an out-of-range position gives an all-zero p_choose, which
        # the forced stop below turns into a READ
        cols_p = torch.arange(key_p.shape[1], device=dev)
        pc_pool = (cols_p[None, None, None, :]
                   == pos[:, None, None, None]).float()
        pc_pool = pc_pool.expand(b, h, 1, key_p.shape[1])
    else:
        energy = _energy(p, cfg, query_step, key_p, "monotonic", kpm_p,
                         add_bias=True)
        pc_pool = mono.learnable_p_choose(energy)           # no noise
    pc = _upsample_p_choose(pc_pool, r, s_max) if cfg.pooled else pc_pool
    pc = pc[:, :, 0, :].reshape(b * h, s_max)

    src_lengths = src_len.repeat_interleave(h, dim=0)[:, None]  # (BH, 1)
    step = state.head_step.reshape(b * h, 1)
    if cfg.mass_preservation:
        max_steps = src_lengths - 1
    else:
        max_steps = src_lengths
        pc = F.pad(pc, (0, 1))
    sp = pc.shape[1]

    # mask the past, force a stop at max_steps, take the first p >= 0.5
    idx = torch.arange(sp, device=dev)[None, :]
    pct = torch.where(idx < step, torch.zeros_like(pc), pc)
    pct = torch.where(idx == max_steps, torch.ones_like(pct), pct)
    fired = (pct >= 0.5).int()
    new_step = (torch.cumsum(fired, dim=1) == 1).int().argmax(dim=1)[:, None]
    step_clamp = torch.minimum(torch.clamp(new_step, min=0), src_lengths - 1)
    # jnp.take_along_axis wraps a negative index (src_len 0) to the end
    at = torch.remainder(torch.clamp(step_clamp, max=s_max - 1), s_max)
    p_i = pc[:, :s_max].gather(1, at)

    head_read = ((new_step == max_steps) & (p_i < 0.5)).reshape(b, h)
    new_state = MonotonicState(
        head_step=new_step.reshape(b, h).to(torch.int32), head_read=head_read)

    # alpha: one-hot at the stopped position
    cols = torch.arange(s_max, device=dev)[None, :]
    alpha = (cols == step_clamp).float()
    if not cfg.mass_preservation:
        alpha = torch.where(new_step == max_steps, torch.zeros_like(alpha),
                            alpha)

    if cfg.soft_attention:
        soft_e = _energy(p, cfg, query_step, key_buf, "soft",
                         cols >= src_len[:, None])
        soft_e = soft_e[:, :, 0, :].reshape(b * h, s_max).float()
        soft_e = soft_e.masked_fill(cols > step_clamp, neg_inf(torch.float32))
        beta = torch.softmax(soft_e, dim=-1)
        beta = torch.where(step_clamp == 0, torch.zeros_like(beta), beta)
    else:
        beta = alpha

    v = _split(linear(p.v_proj, value_buf), h)                # (B, H, S, hd)
    out = (beta.reshape(b, h, 1, s_max).to(v.dtype) @ v).transpose(1, 2)
    return linear(p.out_proj, out.reshape(b, 1, d)), new_state


# ---------------------------------------------------------------------------
# MMA decoder
# ---------------------------------------------------------------------------

class MMADecoderLayer(nn.Module):
    """A decoder layer whose cross-attention is monotonic; the parameter
    names are the JAX tree's."""

    def __init__(self, cfg: MMAConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        d, dcfg = cfg.embed_dim, cfg.decoder
        self.self_attn = attn.MultiheadAttention(d, generator=generator)
        self.self_attn_ln = LayerNorm(d)
        self.encoder_attn = MonotonicAttention(cfg, generator=generator)
        self.encoder_attn_ln = LayerNorm(d)
        self.fc1 = Linear(d, dcfg.ffn_dim, generator=generator)
        self.fc2 = Linear(dcfg.ffn_dim, d, generator=generator)
        self.final_ln = LayerNorm(d)


def mma_decoder_forward(p: tfm.Decoder, cfg: MMAConfig, prev_tokens,
                        encoder_out, key_padding_mask, *,
                        rngs: Optional[RngStream] = None):
    """Teacher-forced forward; dropout and p_choose noise when rngs is
    given.  Returns (logits, attn_list)."""
    dcfg = cfg.decoder
    positions = tfm.positions_from_tokens(prev_tokens, dcfg.padding_idx)
    x = tfm.decoder_embed(p, dcfg, prev_tokens, positions, rngs)
    self_valid = prev_tokens != dcfg.padding_idx
    attn_list = []
    for layer in p.layers:
        x = tfm._sublayer(layer.self_attn, layer.self_attn_ln, dcfg, x, None,
                          key_valid=self_valid, causal=True, rngs=rngs)
        seed = next_seed(rngs)
        generator = None
        if seed is not None:
            generator = torch.Generator(device=x.device).manual_seed(seed)
        x, extra = mma_attention_forward(
            layer.encoder_attn, cfg, layer_norm(layer.encoder_attn_ln, x),
            encoder_out, encoder_out, key_padding_mask, generator=generator,
            epilogue=(x, dcfg.dropout, next_seed(rngs)))
        attn_list.append(extra)
        x = tfm._ffn(layer, dcfg, x, rngs)
    x = layer_norm(p.layer_norm, x)
    return tfm.output_layer(p, dcfg, x), attn_list


class MMADecoderState(NamedTuple):
    caches: Tuple[attn.KVCache, ...]
    monotonic: Tuple[MonotonicState, ...]
    step: torch.Tensor  # (B,) tokens decoded so far, per example


def mma_decoder_init_state(cfg: MMAConfig, batch: int, max_len: int,
                           dtype=None, device=None
                           ) -> MMADecoderState:
    dcfg = cfg.decoder
    dtype = cfg.dtype if dtype is None else dtype
    hd = dcfg.embed_dim // dcfg.num_heads
    return MMADecoderState(
        caches=tuple(attn.kv_cache_init(batch, dcfg.num_heads, max_len, hd,
                                        dtype, device)
                     for _ in range(dcfg.num_layers)),
        monotonic=tuple(monotonic_init_state(batch, dcfg.num_heads, device)
                        for _ in range(dcfg.num_layers)),
        step=torch.zeros(batch, dtype=torch.int64, device=device))


def mma_decoder_step(p: tfm.Decoder, cfg: MMAConfig, state: MMADecoderState,
                     token, key_buf, src_len, online: bool):
    """One incremental decode attempt (no dropout).  Returns (logits (B, V),
    action (B,) int32 with 1 = WRITE and 0 = READ, the attempted state).
    For an example that READs the caller keeps its old state but for the
    monotonic part (`adopt_on_read`)."""
    dcfg = cfg.decoder
    b = token.shape[0]
    pos = dcfg.padding_idx + 1 + state.step
    x = tfm.decoder_embed(p, dcfg, token[:, None], pos[:, None])
    new_caches, new_mono = [], []
    any_read = torch.zeros(b, dtype=torch.bool, device=token.device)
    for layer, cache, mstate in zip(p.layers, state.caches, state.monotonic):
        xh, cache = attn.mha_step(layer.self_attn, cache,
                                  layer_norm(layer.self_attn_ln, x),
                                  dcfg.num_heads)
        x = x + xh
        xh, mstate = mma_attention_step(
            layer.encoder_attn, cfg, mstate,
            layer_norm(layer.encoder_attn_ln, x), key_buf, key_buf, src_len,
            state.step + 1, online)
        x = tfm._ffn(layer, dcfg, x + xh)
        new_caches.append(cache)
        new_mono.append(mstate)
        if online:
            any_read = any_read | mstate.head_read.any(dim=-1)
    x = layer_norm(p.layer_norm, x)
    logits = tfm.output_layer(p, dcfg, x)[:, 0]
    action = torch.where(any_read, 0, 1).to(torch.int32)
    return logits, action, MMADecoderState(
        caches=tuple(new_caches), monotonic=tuple(new_mono),
        step=state.step + 1)


def adopt_on_read(old: MMADecoderState,
                  attempted: MMADecoderState) -> MMADecoderState:
    """READ rollback: the old KV caches (their counts) and step, the
    attempt's advanced monotonic head positions."""
    return MMADecoderState(caches=old.caches, monotonic=attempted.monotonic,
                           step=old.step)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class MMAModel(nn.Module):
    """Encoder and MMA decoder.  Weights from a seeded CPU generator, then
    moved to `device`, the card unless the caller names another;
    compat/jax_bridge.load_jax_params loads a JAX tree instead."""

    def __init__(self, cfg: MMAConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = s2t.S2TEmformerEncoder(cfg, generator=generator,
                                              device=device)
        self.decoder = tfm.Decoder(
            cfg.decoder, generator=generator, device=device,
            make_layer=lambda: MMADecoderLayer(cfg, generator=generator))

    def forward(self, feats, feat_lengths, prev_tokens, *,
                rngs: Optional[RngStream] = None):
        """Teacher-forced forward; dropout and p_choose noise when `rngs` is
        given.  Returns (logits (B, T, V), extra with attn_list)."""
        enc = s2t.encoder_forward(self.encoder, self.cfg, feats, feat_lengths,
                                  rngs)
        t = enc.encoder_out.shape[1]
        kpm = torch.arange(t, device=feats.device)[None, :] \
            >= enc.lengths[:, None]
        logits, attn_list = mma_decoder_forward(
            self.decoder, self.cfg, prev_tokens, enc.encoder_out, kpm,
            rngs=rngs)
        return logits, {"ctc_logits": enc.ctc_logits,
                        "encoder_lengths": enc.lengths,
                        "attn_list": attn_list}
