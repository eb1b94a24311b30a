"""S2T Emformer: causal conv subsampler + conv-pos + Emformer encoder +
Transformer decoder (+ optional CTC head).  Counterpart of
simulst_tpu/models/s2t_emformer.py.

Offline and training: `encoder_forward` runs the whole utterance batch,
with dropout at the config's rates when given an `RngStream` (after the
conv-pos, in every Emformer layer and in the decoder);
`encoder_forward_packed` runs the Emformer stack over sequence-packed rows
(train/packing.py) for training.  Streaming:
`encoder_step` takes one chunk of new feature frames, featurizes it with
the conv caches, and runs every complete segment+rc block through
`emformer_step`; leftover frames stay in a carry buffer whose length is a
host int (no jit here, so the chunk arithmetic simply runs in Python).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from simulst_tpu_torch.nn import conv as cnv
from simulst_tpu_torch.nn import emformer as emf
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import (Linear, RngStream, compute_dtype,
                                       dropout, lengths_to_mask, linear,
                                       next_seed, resolve_device)
from simulst_tpu_torch.train import packing


@dataclasses.dataclass(frozen=True)
class S2TEmformerConfig:
    """Defaults are arch `s2t_emformer_s` (reference s2t_emformer.py:398-413
    on top of fairseq's s2t_transformer_s)."""
    vocab_size: int = 4096 + 4
    input_feat: int = 80
    conv_kernel_sizes: Tuple[int, ...] = (5, 5)
    conv_channels: int = 1024
    embed_dim: int = 256
    ffn_dim: int = 2048
    encoder_layers: int = 12
    encoder_heads: int = 4
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "gelu"
    conv_pos: int = 128
    conv_pos_groups: int = 16
    # Emformer geometry in PRE-subsampling frames (divided by the stride)
    segment_length: int = 64
    left_context: int = 128
    right_context: int = 32
    max_memory: int = 5
    tanh_on_mem: bool = True
    # rematerialise each encoder layer in the backward pass (less activation
    # memory on long utterances for one more forward per layer)
    remat: bool = False
    ctc_layer: bool = False
    no_scale_embedding: bool = False
    decoder_layers: int = 6
    decoder_heads: int = 4
    decoder_ffn_dim: int = 2048
    share_decoder_input_output_embed: bool = True
    max_target_positions: int = 1024
    padding_idx: int = 1
    eos_idx: int = 2
    blank_idx: int = 0
    # activation dtype ("float32" or "bfloat16"); parameters stay fp32 and
    # are cast per op, LayerNorm and softmax statistics are fp32
    compute_dtype: str = "float32"

    @property
    def stride(self) -> int:
        return 2 ** len(self.conv_kernel_sizes)

    @property
    def embed_scale(self) -> float:
        return 1.0 if self.no_scale_embedding else math.sqrt(self.embed_dim)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)

    @property
    def emformer(self) -> emf.EmformerConfig:
        s = self.stride
        return emf.EmformerConfig(
            input_dim=self.embed_dim, num_heads=self.encoder_heads,
            ffn_dim=self.ffn_dim, num_layers=self.encoder_layers,
            dropout=self.dropout, attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout,
            activation=self.activation, left_context=self.left_context // s,
            right_context=self.right_context // s,
            segment=self.segment_length // s, max_memory=self.max_memory,
            tanh_on_mem=self.tanh_on_mem, remat=self.remat)

    @property
    def decoder(self) -> tfm.DecoderConfig:
        return tfm.DecoderConfig(
            vocab_size=self.vocab_size, embed_dim=self.embed_dim,
            ffn_dim=self.decoder_ffn_dim, num_layers=self.decoder_layers,
            num_heads=self.decoder_heads, dropout=self.dropout,
            attention_dropout=self.attention_dropout,
            activation_dropout=self.activation_dropout,
            activation=self.activation,
            share_input_output_embed=self.share_decoder_input_output_embed,
            padding_idx=self.padding_idx, eos_idx=self.eos_idx,
            encoder_embed_dim=self.embed_dim,
            max_target_positions=self.max_target_positions,
            no_scale_embedding=self.no_scale_embedding,
            compute_dtype=self.compute_dtype)


class EncoderOut(NamedTuple):
    encoder_out: torch.Tensor            # (B, T, D)
    lengths: torch.Tensor                # (B,)
    ctc_logits: Optional[torch.Tensor]   # (B, T, V) or None


class S2TEmformerEncoder(nn.Module):
    """Weights from a seeded CPU generator, then moved to `device` (the card
    unless the caller names another)."""

    def __init__(self, cfg: S2TEmformerConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.subsample = cnv.Subsampler(cfg.input_feat, cfg.conv_channels,
                                        cfg.embed_dim, cfg.conv_kernel_sizes,
                                        generator=generator)
        self.conv_pos = cnv.ConvPos(cfg.embed_dim, cfg.conv_pos,
                                    cfg.conv_pos_groups, generator=generator)
        self.emformer = emf.Emformer(cfg.emformer, generator=generator)
        if cfg.ctc_layer:
            self.ctc_layer = Linear(cfg.embed_dim, cfg.vocab_size, bias=False,
                                    init="normal", gain=cfg.embed_dim ** -0.5,
                                    generator=generator)
        else:
            self.ctc_layer = None
        self.to(resolve_device(device))


def _ctc(p: S2TEmformerEncoder, enc):
    return None if p.ctc_layer is None else linear(p.ctc_layer, enc)


def _frontend(p: S2TEmformerEncoder, cfg: S2TEmformerConfig, feats,
              feat_lengths, rngs: Optional[RngStream]):
    """features cast to the compute dtype -> subsample -> scale -> +
    conv-pos -> dropout, zero beyond each example's length: ((B, U, D),
    lengths (B,))."""
    x, lengths = cnv.subsampler_apply(p.subsample, feats.to(cfg.dtype),
                                      feat_lengths)
    x = cfg.embed_scale * x
    x = x + cnv.conv_pos_apply(p.conv_pos, x, cfg.conv_pos_groups)
    x = dropout(x, cfg.dropout, next_seed(rngs))
    x = torch.where(lengths_to_mask(lengths, x.shape[1])[:, :, None], x,
                    torch.zeros_like(x))
    return x, lengths


def encoder_forward(p: S2TEmformerEncoder, cfg: S2TEmformerConfig, feats,
                    feat_lengths, rngs: Optional[RngStream] = None
                    ) -> EncoderOut:
    """Offline / training forward. feats: (B, T, F); feat_lengths: (B,).
    Dropout at the config's rates when rngs is given."""
    x, lengths = _frontend(p, cfg, feats, feat_lengths, rngs)
    x = torch.nn.functional.pad(x, (0, 0, 0, cfg.emformer.right_context))
    enc = emf.emformer_forward(p.emformer, cfg.emformer, x, lengths, rngs)
    return EncoderOut(encoder_out=enc, lengths=lengths, ctc_logits=_ctc(p, enc))


def encoder_forward_packed(p: S2TEmformerEncoder, cfg: S2TEmformerConfig,
                           feats, feat_lengths, plan: packing.PackPlan,
                           rngs: Optional[RngStream] = None) -> EncoderOut:
    """Training forward with sequence packing: the conv frontend runs on
    the padded (B, T) layout as in `encoder_forward`, the Emformer stack
    over the packed rows of `plan` (built for this batch's post-subsample
    lengths) with example-id masking, then the output is unpacked for the
    CTC head and the decoder.  Without dropout it equals `encoder_forward`
    on every valid frame."""
    x, lengths = _frontend(p, cfg, feats, feat_lengths, rngs)
    packed, rc_blocks = packing.pack_frames(x, plan)
    enc_p = emf.emformer_forward_packed(
        p.emformer, cfg.emformer, packed, rc_blocks, plan.frame_eid,
        plan.seg_eid, rngs)
    enc = packing.unpack_frames(enc_p, plan)
    return EncoderOut(encoder_out=enc, lengths=lengths, ctc_logits=_ctc(p, enc))


# ---------------------------------------------------------------------------
# streaming encoder session
# ---------------------------------------------------------------------------

class EncoderStreamState(NamedTuple):
    sub: cnv.SubsamplerCache
    pos: cnv.ConvCache
    emf: emf.EmformerState
    carry: torch.Tensor   # (B, seg + rc, D) post-subsample carry buffer
    carry_len: int        # host int, fixed by the chunk sizes


def encoder_init_state(p: S2TEmformerEncoder, cfg: S2TEmformerConfig,
                       batch: int = 1, dtype=None,
                       device=None) -> EncoderStreamState:
    """The zero state of a session; `dtype` defaults to the config's
    compute dtype."""
    ecfg = cfg.emformer
    dtype = cfg.dtype if dtype is None else dtype
    return EncoderStreamState(
        sub=cnv.subsampler_init_cache(p.subsample, batch, dtype, device),
        pos=cnv.conv_pos_init_cache(p.conv_pos, batch, cfg.embed_dim, dtype,
                                    device),
        emf=emf.emformer_init_state(ecfg, batch, dtype, device),
        carry=torch.zeros(batch, ecfg.segment + ecfg.right_context,
                          cfg.embed_dim, dtype=dtype, device=device),
        carry_len=0)


def _featurize_step(p: S2TEmformerEncoder, cfg: S2TEmformerConfig, sub_cache,
                    pos_cache, feats):
    x, sub_cache = cnv.subsampler_step(p.subsample, sub_cache, feats)
    x = cfg.embed_scale * x
    pos, pos_cache = cnv.conv_pos_step(p.conv_pos, pos_cache, x,
                                       cfg.conv_pos_groups)
    return x + pos, sub_cache, pos_cache


def _subsample_valid_len(cfg: S2TEmformerConfig, n):
    """Per-example valid subsampled length for n (B,) valid input frames:
    0 stays 0, else the causal convs' stride formula."""
    m = n.long()
    for _ in cfg.conv_kernel_sizes:
        m = torch.where(m > 0, (m - 1) // 2 + 1, torch.zeros_like(m))
    return m


def encoder_step(p: S2TEmformerEncoder, cfg: S2TEmformerConfig,
                 state: EncoderStreamState, feats: Optional[torch.Tensor],
                 finish: bool = False,
                 feat_valid: Optional[torch.Tensor] = None
                 ) -> Tuple[EncoderOut, EncoderStreamState]:
    """Process one chunk of NEW feature frames (B, f, F), f % stride == 0
    unless finish, or None; they are cast to the state's dtype.  The
    reference's carry protocol
    (s2t_emformer.py:199-260): prepend the carry, run every complete
    segment + rc block, keep the rest as carry; on finish, right-pad rc
    zeros and flush what is left.  All real frames are reported.

    feat_valid, on the finish call only: (B,) the count of real frames in
    each example's feats, for a batch whose utterances end at different
    offsets (zero-padded by the caller).  The convs are causal, so each
    example's first valid outputs equal an unpadded run's; its frames past
    the valid ones are zeroed (the reference's zero right-pad) before any
    block runs, its blocks past them run with 0 valid frames, and
    `lengths` reports its valid outputs.  What those blocks write into the
    state in place (the memory bank, the left-context keys, past_length)
    touches only that example's later, invalid blocks of the same call:
    the state dies with the finish."""
    ecfg = cfg.emformer
    seg, rc = ecfg.segment, ecfg.right_context
    B = state.carry.shape[0]

    sub_cache, pos_cache = state.sub, state.pos
    if feats is not None and feats.shape[1] > 0:
        x_new, sub_cache, pos_cache = _featurize_step(
            p, cfg, sub_cache, pos_cache, feats.to(state.carry.dtype))
    else:
        x_new = state.carry[:, :0]
    v = state.carry_len + x_new.shape[1]       # real post-subsample frames
    x = torch.cat([state.carry[:, :state.carry_len], x_new], dim=1)
    v_b = None
    if feat_valid is not None:
        if not finish:
            raise ValueError("per-example feat_valid is only defined on the "
                             "finish call")
        v_b = state.carry_len + _subsample_valid_len(
            cfg, feat_valid.to(x.device))                           # (B,)
        keep = torch.arange(x.shape[1], device=x.device)[None, :] < \
            v_b[:, None]
        x = torch.where(keep[:, :, None], x, torch.zeros_like(x))
    if finish:
        x = torch.nn.functional.pad(x, (0, 0, 0, rc))
    size = x.shape[1]

    def run_block(xb, uvc, offset):
        """xb: (B, uvc + rc, D), utterance frames then the rc slot."""
        utt = torch.nn.functional.pad(xb[:, :uvc], (0, 0, 0, seg - uvc))
        blk = torch.cat([utt, xb[:, uvc:]], dim=1)
        if v_b is None:
            uv = torch.full((B,), uvc, dtype=torch.int32, device=x.device)
        else:
            uv = torch.clamp(v_b - offset, 0, uvc).to(torch.int32)
        return emf.emformer_step(p.emformer, ecfg, state.emf, blk, uv)[:, :uvc]

    outputs = []
    o = 0
    while (size - o) >= seg + rc and (v - o) >= seg:
        outputs.append(run_block(x[:, o:o + seg + rc], seg, o))
        o += seg
    if finish and v - o > 0:
        rem = v - o                             # < seg real frames left
        outputs.append(run_block(x[:, o:o + rem + rc], rem, o))
        o += rem
    enc = torch.cat(outputs, dim=1) if outputs else x[:, :0]

    carry_len = 0 if finish else size - o
    carry = torch.zeros_like(state.carry)
    carry[:, :carry_len] = x[:, o:o + carry_len]
    new_state = EncoderStreamState(sub=sub_cache, pos=pos_cache, emf=state.emf,
                                   carry=carry, carry_len=carry_len)
    if v_b is None:
        lengths = torch.full((B,), enc.shape[1], dtype=torch.int64,
                             device=x.device)
    else:
        lengths = torch.clamp(v_b, max=enc.shape[1])
    return EncoderOut(encoder_out=enc, lengths=lengths,
                      ctc_logits=_ctc(p, enc)), new_state


def make_encoder_stepper(p: S2TEmformerEncoder, cfg: S2TEmformerConfig):
    """step(state, feats, finish=False, feat_valid=None) -> (EncoderOut,
    state): the streaming session's per-chunk call with the weights
    bound."""
    def step(state: EncoderStreamState, feats, finish: bool = False,
             feat_valid: Optional[torch.Tensor] = None):
        return encoder_step(p, cfg, state, feats, finish, feat_valid)

    return step


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

class S2TEmformerModel(nn.Module):
    """Encoder-decoder ASR/ST model.  Weights come from a seeded CPU
    generator with the JAX package's init distributions, then move to
    `device`, the card unless the caller names another;
    `compat/jax_bridge.py` loads JAX weights instead."""

    def __init__(self, cfg: S2TEmformerConfig, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.encoder = S2TEmformerEncoder(cfg, generator=generator,
                                          device=device)
        self.decoder = tfm.Decoder(cfg.decoder, generator=generator,
                                   device=device)

    def forward(self, feats, feat_lengths, prev_tokens, *,
                rngs: Optional[RngStream] = None,
                pack_plan: Optional[packing.PackPlan] = None):
        """Teacher-forced forward; dropout when `rngs` is given (the JAX
        package's rng with deterministic=False).  `pack_plan`, a
        train/packing.PackPlan of this batch's post-subsample lengths, runs
        the Emformer stack over sequence-packed rows.  Returns (logits (B,
        T, V), extra)."""
        if pack_plan is None:
            enc = encoder_forward(self.encoder, self.cfg, feats,
                                  feat_lengths, rngs)
        else:
            enc = encoder_forward_packed(self.encoder, self.cfg, feats,
                                         feat_lengths, pack_plan, rngs)
        enc_valid = lengths_to_mask(enc.lengths, enc.encoder_out.shape[1])
        logits = tfm.decoder_forward(self.decoder, self.cfg.decoder,
                                     prev_tokens, enc.encoder_out, enc_valid,
                                     rngs=rngs)
        return logits, {"ctc_logits": enc.ctc_logits,
                        "encoder_lengths": enc.lengths,
                        "encoder_out": enc.encoder_out}
