"""Emformer streaming encoder (counterpart of simulst_tpu/nn/emformer.py).

Offline and training (`emformer_forward`): per layer, one attention over
[rc blocks | utterance | summaries] queries and [mems | rc blocks |
utterance] keys, batched per segment.  When whole segments divide into
groups (`_choose_group` > 1) the layer takes the grouped path: the CUDA
kernels `emformer_grouped_attention` (attention dropout inside) and
`fused_linear_res` (out_proj + residual dropout + residual).  A ragged
utterance takes `_segmented_attention` in plain torch, with its dropout,
as the JAX package takes XLA there.  Either way the pos_ff block is the
`fused_ln_ffn_res` kernel with both of its dropout sites.  Every kernel has
its backward; with an `RngStream` each dropout site draws one seed (the
JAX package's per-layer rng stream, in the same site order), and without
one nothing is dropped.

Sequence-packed training (`emformer_forward_packed`, train/packing.py):
rows hold several examples at segment granularity, and the per-example
length rule gives way to example-id equality (`make_packed_eids`): the
grouped path hands the ids to the attention kernel as its gate, the
segmented path folds them into the key validity.

Streaming (`emformer_step`): per-layer state is fixed-size buffers (mems
(B, M, D), left-context K/V (B, L, D)) valid at their end, plus
past_length; validity is key masking.  Where the JAX package returns new
buffers, `_shift_append` writes the shifted buffer back in place.

Layers are pre-LN by default (`normalize_before`); post-LN drops the
attention's input LN, normalises each layer's output with `ln_input`
after the pos_ff block and skips `final_ln` (which stays a parameter).
`segmented_attention=False` names the JAX package's dense O(T^2) training
attention, which equals the segmented one up to rounding: the port computes
the segmented (or grouped) attention for either value, and only the packed
forward refuses False, as JAX asserts.  `remat` recomputes each layer in
the backward (torch.utils.checkpoint); a layer's dropout seeds are recorded on its
first run and replayed by the recomputation, which so redraws the same
masks (its kernels' forward launches count twice).
Semantics notes (reference torchaudio emformer.py): summaries are the
ceil-mode mean over the pre-attention-LN utterance (layer 0 pools the raw
utterance); memory outputs pass tanh (or clamp to [-10, 10]); a summary
query never attends the memory bank; a layer's state stores its INPUT
mems, while its summary output becomes the next layer's input mems.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from simulst_tpu_torch import comm
from simulst_tpu_torch.nn.core import (LayerNorm, Linear, RngStream, cast,
                                       dropout, layer_norm, linear,
                                       masked_softmax, next_seed)
from simulst_tpu_torch.ops.emformer_attn import (AttnGeom, EidGate,
                                                 emformer_grouped_attention,
                                                 max_visible_score)
from simulst_tpu_torch.ops.ffn import fused_ln_ffn_res
from simulst_tpu_torch.ops.linear_res import fused_linear_res


@dataclasses.dataclass(frozen=True)
class EmformerConfig:
    input_dim: int = 256
    num_heads: int = 4
    ffn_dim: int = 2048
    num_layers: int = 12
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.1
    activation: str = "gelu"
    left_context: int = 32     # post-subsample frames (128 / stride 4)
    right_context: int = 8     # 32 / 4
    segment: int = 16          # 64 / 4
    max_memory: int = 5
    tanh_on_mem: bool = True
    normalize_before: bool = True
    # recompute each layer in the backward pass (activation memory)
    remat: bool = False
    # JAX's choice of per-segment (True) or dense O(T^2) training attention,
    # equal up to rounding; the port computes the per-segment one for both
    segmented_attention: bool = True
    # G consecutive segments per attention block over their union context
    segment_group: int = 8

    @property
    def use_mem(self) -> bool:
        return self.max_memory > 0


# ---------------------------------------------------------------------------
# parameters (names mirror the JAX pytree)
# ---------------------------------------------------------------------------

class EmformerAttention(nn.Module):
    def __init__(self, dim: int, gain: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # fused key/value projection (D, 2D), split after the product
        self.emb_to_key_value = Linear(dim, 2 * dim, init="xavier", gain=gain,
                                       generator=generator)
        self.emb_to_query = Linear(dim, dim, init="xavier", gain=gain,
                                   generator=generator)
        self.out_proj = Linear(dim, dim, init="torch", generator=generator)


class PosFF(nn.Module):
    def __init__(self, dim: int, ffn_dim: int, gain: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln = LayerNorm(dim)
        self.fc1 = Linear(dim, ffn_dim, init="xavier", gain=gain,
                          generator=generator)
        self.fc2 = Linear(ffn_dim, dim, init="xavier", gain=gain,
                          generator=generator)


class EmformerLayer(nn.Module):
    def __init__(self, cfg: EmformerConfig, gain: float, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.attention = EmformerAttention(cfg.input_dim, gain,
                                           generator=generator)
        self.ln_input = LayerNorm(cfg.input_dim)
        self.pos_ff = PosFF(cfg.input_dim, cfg.ffn_dim, gain,
                            generator=generator)


class Emformer(nn.Module):
    """Depthwise init gains 1/sqrt(layer+1) (reference emformer.py:51-59)."""

    def __init__(self, cfg: EmformerConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            EmformerLayer(cfg, 1.0 / math.sqrt(i + 1), generator=generator)
            for i in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.input_dim)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _num_segs(utterance_len: int, segment: int) -> int:
    return -(-utterance_len // segment)


def _segment_means(x, segment: int):
    """Ceil-mode AvgPool1d over time: (B, U, D) -> (B, ceil(U/seg), D),
    divided by each window's real size."""
    b, u, d = x.shape
    n = _num_segs(u, segment)
    xp = torch.nn.functional.pad(x, (0, 0, 0, n * segment - u))
    sums = xp.reshape(b, n, segment, d).sum(dim=2)
    sizes = np.minimum(segment, u - np.arange(n) * segment).astype(np.float32)
    return sums / torch.as_tensor(sizes, device=x.device)[None, :, None].to(x.dtype)


def _mem_transform(x, cfg: EmformerConfig):
    return torch.tanh(x) if cfg.tanh_on_mem else torch.clamp(x, -10, 10)


def _pos_ff_res(p: PosFF, cfg: EmformerConfig, x,
                rngs: Optional[RngStream] = None):
    """x + drop(fc2(drop(act(fc1(LN(x)))))): one fused_ln_ffn_res kernel on
    the card; one seed keys both dropout sites.  The linear parameters
    are cast to the activation dtype; the LN's stay fp32, as the JAX
    package passes them."""
    d = x.dtype
    seed = next_seed(rngs)
    on = seed is not None
    return fused_ln_ffn_res(x, p.ln.scale, p.ln.bias, cast(p.fc1.weight, d),
                            cast(p.fc1.bias, d), cast(p.fc2.weight, d),
                            cast(p.fc2.bias, d), cfg.activation,
                            cfg.activation_dropout if on else 0.0,
                            cfg.dropout if on else 0.0, seed or 0)


def _attend(q, k, v, num_heads: int, visible):
    """q: (B, Tq, D); k/v: (B, Tk, D); visible broadcastable to
    (B, 1, Tq, Tk).  fp32 softmax; rows with no visible key give zeros."""
    b, tq, d = q.shape
    hd = d // num_heads
    qh = q.reshape(b, tq, num_heads, hd).transpose(1, 2) * (hd ** -0.5)
    kh = k.reshape(b, -1, num_heads, hd).transpose(1, 2)
    vh = v.reshape(b, -1, num_heads, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)).float()
    probs = masked_softmax(scores, visible).to(q.dtype)
    return (probs @ vh).transpose(1, 2).reshape(b, tq, d)


@functools.lru_cache(maxsize=64)
def _rc_gather_indices(U: int, seg: int, rc: int) -> np.ndarray:
    """Indices into the (U+rc)-long input of the per-segment right-context
    blocks (reference emformer.py:700-709)."""
    n = _num_segs(U, seg)
    starts = [(i + 1) * seg for i in range(n - 1)] + [U]
    return np.concatenate([np.arange(s, s + rc) for s in starts]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _segment_gather_indices(U: int, seg: int, lc: int, rc: int, max_mem: int,
                            use_mem: bool):
    """Per-segment gather indices into the [mems | rc | utt] key rows.
    Returns (idx (n, ctx), valid (n, ctx), utt_col (n, ctx) frame or -1)."""
    n = _num_segs(U, seg)
    mem_len = (n - 1) if use_mem else 0
    rc_len = n * rc
    m_slots = max_mem if use_mem else 0
    ctx = m_slots + rc + lc + seg
    idx = np.zeros((n, ctx), np.int64)
    valid = np.zeros((n, ctx), bool)
    utt_col = np.full((n, ctx), -1, np.int64)
    for i in range(n):
        col = 0
        for j in range(m_slots):
            m = i - m_slots + j
            idx[i, col] = max(m, 0)
            valid[i, col] = m >= 0
            col += 1
        for j in range(rc):
            idx[i, col] = mem_len + i * rc + j
            valid[i, col] = True
            col += 1
        for j in range(lc + seg):
            u = i * seg - lc + j
            ok = 0 <= u < U
            idx[i, col] = mem_len + rc_len + (u if ok else 0)
            valid[i, col] = ok
            utt_col[i, col] = u if ok else -1
            col += 1
    return idx, valid, utt_col


# ---------------------------------------------------------------------------
# sequence packing: example ids (train/packing.py supplies them)
#
# A packed row holds several examples at segment granularity; the length
# rule generalizes to EXAMPLE-ID EQUALITY: a query of segment i (example e)
# sees a memory summary, rc row or utterance frame only if it carries the
# same id.  Dead frames and segments carry -1.
# ---------------------------------------------------------------------------

# the JAX package's PackedEids without its frame ids (they only build kid)
# and its dense int8 kernel mask (the port's kernel reads the ids): the
# grouped-attention kernel's gate itself
PackedEids = EidGate


def _build_kid(cfg: EmformerConfig, frame_eid, seg_eid):
    """(B, U) + (B, n) -> (B, (n-1) + n*rc + U) per-key-row example ids in
    the [mems | rc blocks | utterance] layout."""
    mem_id = seg_eid[:, :-1] if cfg.use_mem else seg_eid[:, :0]
    rc_id = seg_eid.repeat_interleave(cfg.right_context, dim=1)
    return torch.cat([mem_id, rc_id, frame_eid], dim=1)


def make_packed_eids(cfg: EmformerConfig, frame_eid, seg_eid) -> PackedEids:
    """The layer-invariant example ids of packed rows (frame_eid (B, U),
    seg_eid (B, n)): per key row and per segment, int32 on the ids'
    device."""
    frame_eid = torch.as_tensor(frame_eid).to(torch.int32)
    seg_eid = torch.as_tensor(seg_eid, device=frame_eid.device).to(
        torch.int32)
    return PackedEids(kid=_build_kid(cfg, frame_eid, seg_eid),
                      seg_eid=seg_eid)


def _choose_group(n: int, U: int, cfg: EmformerConfig) -> int:
    """Largest G <= cfg.segment_group dividing n whose first group's
    utterance window fits ((n - G) * seg >= lc); 1 when none applies
    (ragged U, memory off)."""
    if not (cfg.use_mem and cfg.segment_group > 1 and U == n * cfg.segment
            and n >= 2):
        return 1
    for g in range(min(cfg.segment_group, n), 1, -1):
        if n % g == 0 and (n - g) * cfg.segment >= cfg.left_context:
            return g
    return 1


# ---------------------------------------------------------------------------
# offline forward
# ---------------------------------------------------------------------------

def _grouped_attention(p: EmformerLayer, cfg: EmformerConfig, G: int, utt_ln,
                       rc_ln, mems, summary, lengths, rc_raw, utt_raw,
                       rngs: Optional[RngStream] = None,
                       eids: Optional[PackedEids] = None):
    """Grouped-segment attention with its epilogue: the attention core
    kernel (attention dropout inside), then out_proj + residual dropout +
    residual on the rc/utterance rows (summary rows get the plain
    projection) in one fused_linear_res kernel.  Returns (result (B,
    rc_len+U, D) post-residual, summary_out (B, n, D)).  With `eids`
    (sequence packing, whose rows are full: `lengths` U) the kernel's
    example-id gate takes the place of the length rule."""
    b, U, d = utt_ln.shape
    seg, rc = cfg.segment, cfg.right_context
    n = U // seg
    ng = n // G
    ap = p.attention
    geom = AttnGeom(U=U, seg=seg, lc=cfg.left_context, rc=rc,
                    max_mem=cfg.max_memory, G=G, num_heads=cfg.num_heads)
    kv = linear(ap.emb_to_key_value, torch.cat([mems, rc_ln, utt_ln], dim=1))
    k, v = kv.chunk(2, dim=-1)
    q_in = torch.cat([rc_ln.reshape(b, ng, G * rc, d),
                      utt_ln.reshape(b, ng, G * seg, d),
                      summary.reshape(b, ng, G, d)], dim=2)
    q = linear(ap.emb_to_query, q_in)
    if _score_monitor is not None:
        _record_score(max_visible_score(q, k, v, lengths.to(torch.int32),
                                        geom, eids))
    seed = next_seed(rngs)
    out = emformer_grouped_attention(
        q, k, v, lengths.to(torch.int32), geom,
        cfg.attention_dropout if seed is not None else 0.0, seed or 0,
        gate=eids)
    # residual = raw (pre-LN) input in the grouped row layout, zeros under
    # the summary rows (which ignore it)
    res = torch.cat([rc_raw.reshape(b, ng, G * rc, d),
                     utt_raw.reshape(b, ng, G * seg, d),
                     torch.zeros(b, ng, G, d, dtype=out.dtype,
                                 device=out.device)], dim=2)
    seed = next_seed(rngs)
    y = fused_linear_res(out, cast(ap.out_proj.weight, out.dtype),
                         cast(ap.out_proj.bias, out.dtype), res,
                         period=geom.nq, res_rows=G * (rc + seg),
                         rate=cfg.dropout if seed is not None else 0.0,
                         seed=seed or 0)
    rc_res = y[:, :, :G * rc].reshape(b, n * rc, d)
    utt_res = y[:, :, G * rc:G * (rc + seg)].reshape(b, U, d)
    summary_out = y[:, :, G * (rc + seg):].reshape(b, n, d)
    return torch.cat([rc_res, utt_res], dim=1), summary_out


# The attention-score monitor of the JAX package's convergence gates: its
# XLA attention takes exp(min(s, SCORE_CLAMP)), so a score near the clamp
# would flatten the softmax silently.  The port's kernels and plain
# versions subtract the row max and have no clamp; a gate records the
# largest pre-softmax score of every attention pass (scaled by 1 / sqrt
# hd, visible pairs only) while the monitor is on, and holds it to JAX's
# margin, SCORE_CLAMP / 2, so that a model trained here stays one the JAX
# package computes the same.  Recording reads the scores back to the host.
SCORE_CLAMP = 80.0
_score_monitor = None


def enable_score_monitor():
    """Start recording the largest pre-softmax attention score of each
    pass into a host list, which is returned; disable_score_monitor()
    stops."""
    global _score_monitor
    _score_monitor = []
    return _score_monitor


def disable_score_monitor():
    global _score_monitor
    _score_monitor = None


def _record_score(m):
    if _score_monitor is not None:
        _score_monitor.append(float(m.detach()))


def _segmented_attention(p: EmformerLayer, cfg: EmformerConfig, utt_ln, rc_ln,
                         mems, summary, lengths,
                         rngs: Optional[RngStream] = None,
                         eids: Optional[PackedEids] = None):
    """Per-segment batched attention in plain torch (ragged U), attention
    dropout included.  Returns (rc_utt_out (B, rc_len+U, D), summary_out
    (B, n, D)) before the residual.  With `eids` (sequence packing) a key
    is valid where its example id equals the query segment's, in place of
    the length rule (all query rows of a segment share one id, so the gate
    folds into the key validity)."""
    b, U, d = utt_ln.shape
    n = _num_segs(U, cfg.segment)
    seg, rc = cfg.segment, cfg.right_context
    h = cfg.num_heads
    hd = d // h
    dev = utt_ln.device
    ap = p.attention
    kv = linear(ap.emb_to_key_value, torch.cat([mems, rc_ln, utt_ln], dim=1))
    k, v = kv.chunk(2, dim=-1)

    idx, valid, utt_col = (torch.as_tensor(a, device=dev) for a in
                           _segment_gather_indices(U, seg, cfg.left_context,
                                                   rc, cfg.max_memory,
                                                   cfg.use_mem))
    ctx = idx.shape[1]
    k_ctx = k.index_select(1, idx.reshape(-1)).reshape(b, n, ctx, h, hd)
    v_ctx = v.index_select(1, idx.reshape(-1)).reshape(b, n, ctx, h, hd)
    if eids is None:
        in_len = (utt_col[None] < lengths[:, None, None]) | \
            (utt_col[None] < 0)
        key_valid = valid[None] & in_len                        # (B, n, ctx)
    else:
        kid = eids.kid.index_select(1, idx.reshape(-1)).reshape(b, n, ctx)
        key_valid = valid[None] & (kid == eids.seg_eid[:, :, None])

    pad_u = n * seg - U
    utt_q = torch.nn.functional.pad(utt_ln, (0, 0, 0, pad_u)).reshape(
        b, n, seg, d)
    parts = [rc_ln.reshape(b, n, rc, d), utt_q]
    ns = 1 if cfg.use_mem else 0   # summary rows per segment
    if ns:
        parts.append(summary.reshape(b, n, 1, d))
    q = linear(ap.emb_to_query, torch.cat(parts, dim=2))        # (B, n, nq, D)
    nq = q.shape[2]

    qh = q.reshape(b, n, nq, h, hd).transpose(2, 3) * (hd ** -0.5)
    kh = k_ctx.permute(0, 1, 3, 4, 2)
    vh = v_ctx.transpose(2, 3)
    scores = (qh @ kh).float()                                  # (B,n,h,nq,ctx)
    visible = key_valid[:, :, None, None, :]
    if ns:
        # summary rows don't attend the memory slots
        m_slots = cfg.max_memory
        row_is_summary = torch.arange(nq, device=dev) == nq - 1
        col_is_mem = torch.arange(ctx, device=dev) < m_slots
        visible = visible & ~(row_is_summary[:, None] & col_is_mem[None, :])
    if _score_monitor is not None:
        _record_score(scores.masked_fill(~visible, -math.inf).max())
    probs = masked_softmax(scores, visible).to(q.dtype)
    probs = dropout(probs, cfg.attention_dropout, next_seed(rngs))
    out = (probs @ vh).transpose(2, 3).reshape(b, n, nq, d)
    out = linear(ap.out_proj, out)

    rc_out = out[:, :, :rc].reshape(b, n * rc, d)
    utt_out = out[:, :, rc:rc + seg].reshape(b, n * seg, d)[:, :U]
    summary_out = out[:, :, rc + seg:].reshape(b, n * ns, d)
    return torch.cat([rc_out, utt_out], dim=1), summary_out


def _layer_forward(p: EmformerLayer, cfg: EmformerConfig, utterance,
                   rc_blocks, mems, lengths, rngs: Optional[RngStream] = None,
                   eids: Optional[PackedEids] = None):
    """One Emformer layer, offline or training.  Returns (utt_out, rc_out,
    next_mems).  `eids` switches the masking to sequence-packed example-id
    equality."""
    U = utterance.shape[1]
    rc_len = rc_blocks.shape[1]
    raw = torch.cat([rc_blocks, utterance], dim=1)
    ln = layer_norm(p.ln_input, raw) if cfg.normalize_before else raw
    rc_ln, utt_ln = ln[:, :rc_len], ln[:, rc_len:]
    summary = (_segment_means(utt_ln, cfg.segment) if cfg.use_mem
               else utt_ln[:, :0])
    n = _num_segs(U, cfg.segment)

    G = _choose_group(n, U, cfg)
    if G > 1:
        result, summary_out = _grouped_attention(
            p, cfg, G, utt_ln, rc_ln, mems, summary, lengths, rc_blocks,
            utterance, rngs, eids)
    else:
        rc_utt_out, summary_out = _segmented_attention(
            p, cfg, utt_ln, rc_ln, mems, summary, lengths, rngs, eids)
        result = dropout(rc_utt_out, cfg.dropout, next_seed(rngs)) + raw
    next_mems = (_mem_transform(summary_out, cfg)[:, :n - 1] if cfg.use_mem
                 else mems)
    result = _pos_ff_res(p.pos_ff, cfg, result, rngs)
    if not cfg.normalize_before:
        result = layer_norm(p.ln_input, result)
    return result[:, rc_len:], result[:, :rc_len], next_mems


class _SeedRecord:
    """A layer's dropout seeds for torch.utils.checkpoint: the first run
    draws them from `rngs` in the layer's own order and records them; a
    run after `rewind()` (the backward's recomputation) replays them, so
    it redraws the same masks."""

    def __init__(self, rngs: RngStream):
        self.rngs, self.seeds, self.i = rngs, [], 0

    def rewind(self):
        self.i = 0

    def next(self) -> int:
        if self.i == len(self.seeds):
            self.seeds.append(self.rngs.next())
        self.i += 1
        return self.seeds[self.i - 1]


def _run_layers(p: Emformer, cfg: EmformerConfig, out, rc_blocks, mems,
                lengths, rngs: Optional[RngStream],
                eids: Optional[PackedEids] = None):
    """Every layer in turn; with cfg.remat each one under
    torch.utils.checkpoint (non-reentrant), its seeds recorded."""
    for layer in p.layers:
        if not cfg.remat or not torch.is_grad_enabled():
            out, rc_blocks, mems = _layer_forward(layer, cfg, out, rc_blocks,
                                                  mems, lengths, rngs, eids)
            continue
        record = None if rngs is None else _SeedRecord(rngs)

        def one_layer(out, rc_blocks, mems, layer=layer, record=record):
            if record is not None:
                record.rewind()
            return _layer_forward(layer, cfg, out, rc_blocks, mems, lengths,
                                  record, eids)

        out, rc_blocks, mems = checkpoint(one_layer, out, rc_blocks, mems,
                                          use_reentrant=False)
    return out, rc_blocks, mems


def emformer_forward(p: Emformer, cfg: EmformerConfig, x, lengths,
                     rngs: Optional[RngStream] = None):
    """x: (B, U + right_context, D), the utterance right-padded with rc
    frames; lengths: (B,) valid utterance frames.  Dropout at the config's
    rates when rngs is given.  Returns the encoded utterance (B, U, D)."""
    U = x.shape[1] - cfg.right_context
    utterance = x[:, :U]
    idx = torch.as_tensor(_rc_gather_indices(U, cfg.segment,
                                             cfg.right_context),
                          device=x.device)
    rc_blocks = x.index_select(1, idx)
    if cfg.use_mem:
        n = _num_segs(U, cfg.segment)
        mems = _segment_means(utterance, cfg.segment)[:, :n - 1]
    else:
        mems = utterance[:, :0]
    out, _, _ = _run_layers(p, cfg, utterance, rc_blocks, mems, lengths, rngs)
    return layer_norm(p.final_ln, out) if cfg.normalize_before else out


def emformer_forward_packed(p: Emformer, cfg: EmformerConfig, utterance,
                            rc_blocks, frame_eid, seg_eid,
                            rngs: Optional[RngStream] = None):
    """Training forward over SEQUENCE-PACKED rows (train/packing.py).

    utterance: (R, Up, D) packed frontend features (dead frames zero);
    rc_blocks: (R, n*rc, D), the right context gathered with ZERO rows at
    example boundaries (packing.pack_frames); frame_eid (R, Up) and seg_eid
    (R, n): example ids, -1 dead.  Without dropout the output at every
    frame of every example equals the padded-batch `emformer_forward`'s;
    with dropout the packed layout draws its own masks.  Returns (R, Up, D);
    packing.unpack_frames puts it back in the batch's layout."""
    if not cfg.segmented_attention:
        raise ValueError("sequence packing requires segmented_attention=True")
    U = utterance.shape[1]
    n = _num_segs(U, cfg.segment)
    if U != n * cfg.segment:
        raise ValueError(f"packed rows must be whole segments, got {U} "
                         f"frames of {cfg.segment}-frame segments")
    eids = make_packed_eids(cfg, frame_eid, seg_eid)
    mems = (_segment_means(utterance, cfg.segment)[:, :n - 1] if cfg.use_mem
            else utterance[:, :0])
    # packed rows are full: the frame < length rule never bites
    lengths = torch.full((utterance.shape[0],), U, dtype=torch.int32,
                         device=utterance.device)
    out, _, _ = _run_layers(p, cfg, utterance, rc_blocks, mems, lengths, rngs,
                            eids)
    return layer_norm(p.final_ln, out) if cfg.normalize_before else out


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

class EmformerLayerState(NamedTuple):
    mems: torch.Tensor   # (B, M, D), valid entries at the END of the buffer
    lc_k: torch.Tensor   # (B, L, D), ditto
    lc_v: torch.Tensor   # (B, L, D)


class EmformerState(NamedTuple):
    layers: Tuple[EmformerLayerState, ...]
    past_length: torch.Tensor  # (B,) int32


def emformer_init_state(cfg: EmformerConfig, batch: int, dtype=torch.float32,
                        device=None) -> EmformerState:
    def zeros(n):
        return torch.zeros(batch, n, cfg.input_dim, dtype=dtype, device=device)

    return EmformerState(
        layers=tuple(EmformerLayerState(mems=zeros(cfg.max_memory),
                                        lc_k=zeros(cfg.left_context),
                                        lc_v=zeros(cfg.left_context))
                     for _ in range(cfg.num_layers)),
        past_length=torch.zeros(batch, dtype=torch.int32, device=device))


def _shift_append(buf, new, valid_new):
    """buf: (B, N, D) valid at its end; new: (B, S, D) whose first
    `valid_new` rows are valid.  Writes the last N rows of the stream
    [buf, new[:valid_new]] back into `buf` in place (the JAX package returns
    a new buffer) and returns it."""
    b, n_buf, d = buf.shape
    full = torch.cat([buf, new], dim=1)
    rows = valid_new.long()[:, None] + torch.arange(n_buf, device=buf.device)
    buf.copy_(full.gather(1, rows[:, :, None].expand(b, n_buf, d)))
    return buf


def _layer_step(p: EmformerLayer, cfg: EmformerConfig,
                lstate: EmformerLayerState, utterance, rc, in_mems, utt_valid,
                past_length):
    """One streaming chunk through one layer.  utterance: (B, S, D), first
    utt_valid frames valid; rc: (B, R, D); in_mems: (B, 1, D) this layer's
    input memory element.  Returns (utt_out, rc_out, mems_out); `lstate`
    is updated in place."""
    b, S, d = utterance.shape
    R = rc.shape[1]
    M, L = cfg.max_memory, cfg.left_context
    dev = utterance.device

    raw = torch.cat([rc, utterance], dim=1)
    ln = layer_norm(p.ln_input, raw) if cfg.normalize_before else raw
    rc_ln, utt_ln = ln[:, :R], ln[:, R:]
    utt_ok = torch.arange(S, device=dev)[None, :] < utt_valid[:, None]
    if cfg.use_mem:
        denom = torch.clamp_min(utt_valid, 1).to(utt_ln.dtype)[:, None, None]
        summary = (utt_ln * utt_ok[:, :, None]).sum(dim=1, keepdim=True) / denom
    else:
        summary = utt_ln[:, :0]
    ns = summary.shape[1]

    ap = p.attention
    q = linear(ap.emb_to_query, torch.cat([rc_ln, utt_ln, summary], dim=1))
    kv = linear(ap.emb_to_key_value,
                torch.cat([lstate.mems, rc_ln, utt_ln], dim=1))
    k, v = kv.chunk(2, dim=-1)
    k_full = torch.cat([k[:, :M + R], lstate.lc_k, k[:, M + R:]], dim=1)
    v_full = torch.cat([v[:, :M + R], lstate.lc_v, v[:, M + R:]], dim=1)

    # validity: mems last vm, rc all, lc last vl, utt first utt_valid
    vm = torch.clamp_max(-(-past_length // cfg.segment), M)    # ceil(past/seg)
    vl = torch.clamp_max(past_length, L)
    mem_ok = torch.arange(M, device=dev)[None, :] >= (M - vm)[:, None]
    lc_ok = torch.arange(L, device=dev)[None, :] >= (L - vl)[:, None]
    key_valid = torch.cat([mem_ok, torch.ones(b, R, dtype=torch.bool,
                                              device=dev), lc_ok, utt_ok], 1)
    # the summary query row must not see the memory bank (reference :299-302)
    tq, tk = R + S + ns, M + R + L + S
    allowed = torch.ones(tq, tk, dtype=torch.bool, device=dev)
    if ns:
        allowed[tq - 1, :M] = False
    out = _attend(q, k_full, v_full, cfg.num_heads,
                  key_valid[:, None, None, :] & allowed)
    out = linear(ap.out_proj, out)

    mems_out = (_mem_transform(out[:, R + S:], cfg) if cfg.use_mem
                else out[:, :0])
    result = _pos_ff_res(p.pos_ff, cfg, out[:, :R + S] + raw)
    if not cfg.normalize_before:
        result = layer_norm(p.ln_input, result)

    if cfg.use_mem:
        _shift_append(lstate.mems, in_mems, torch.ones_like(utt_valid))
    _shift_append(lstate.lc_k, k[:, M + R:], utt_valid)
    _shift_append(lstate.lc_v, v[:, M + R:], utt_valid)
    return result[:, R:], result[:, :R], mems_out


def emformer_step(p: Emformer, cfg: EmformerConfig, state: EmformerState, x,
                  utt_valid) -> torch.Tensor:
    """One streaming chunk.  x: (B, segment + right_context, D) arranged
    [utterance | rc]; the first `utt_valid` utterance frames are real, the
    rest zeros (only on the final flush).  Updates `state` in place and
    returns utt_out (B, S, D)."""
    S = cfg.segment
    utterance, rc = x[:, :S], x[:, S:]
    if cfg.use_mem:
        uv = torch.arange(S, device=x.device)[None, :] < utt_valid[:, None]
        denom = torch.clamp_min(utt_valid, 1).to(x.dtype)[:, None, None]
        mems = (utterance * uv[:, :, None]).sum(dim=1, keepdim=True) / denom
    else:
        mems = utterance[:, :0]
    out = utterance
    for layer, lstate in zip(p.layers, state.layers):
        out, rc, mems = _layer_step(layer, cfg, lstate, out, rc, mems,
                                    utt_valid, state.past_length)
    state.past_length.add_(utt_valid.to(state.past_length.dtype))
    return layer_norm(p.final_ln, out) if cfg.normalize_before else out


# ---------------------------------------------------------------------------
# sequence-parallel training forward: segments sharded over a "seq" axis
#
# The reference has no sequence parallelism (SURVEY.md §2.6).  Each rank of
# the seq axis takes a contiguous block of whole segments; per layer it
# needs only small halos from its left neighbour (lc layer-normed frames
# and M memory summaries) and, once at input, rc lookahead frames from its
# right neighbour: three shifts (comm.shift), everything else local.
# Math identical to emformer_forward.  The attention is plain torch, as the
# JAX package's is XLA here; the pos_ff block is the LN-FFN kernel.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _segment_gather_indices_local(n_loc: int, seg: int, lc: int, rc: int,
                                  max_mem: int):
    """Gather indices of one shard's segments into its key rows
    [mems_ext (M + n_loc) | rc (n_loc * rc) | utt_ext (lc + n_loc * seg)].

    Returns (idx, kind, gpos), each (n_loc, ctx): kind 0 memory, 1 rc,
    2 utterance; gpos the shard-relative global position (memory slots:
    the segment index less the shard's first segment; utterance slots: the
    frame index less the shard's first frame), from which the validity
    follows once the shard's offset is known."""
    M = max_mem
    ctx = M + rc + lc + seg
    idx = np.zeros((n_loc, ctx), np.int64)
    kind = np.zeros((n_loc, ctx), np.int64)
    gpos = np.zeros((n_loc, ctx), np.int64)
    rc_base = M + n_loc
    utt_base = rc_base + n_loc * rc
    for i in range(n_loc):
        col = 0
        for jj in range(M):
            # mems_ext[t] holds the summary of segment o_seg - M + t; slot
            # jj of segment i wants segment i - M + jj
            idx[i, col], kind[i, col], gpos[i, col] = i + jj, 0, i - M + jj
            col += 1
        for j in range(rc):
            idx[i, col], kind[i, col] = rc_base + i * rc + j, 1
            col += 1
        for j in range(lc + seg):
            # utt_ext[t] holds frame o_frames - lc + t
            idx[i, col], kind[i, col] = utt_base + i * seg + j, 2
            gpos[i, col] = i * seg - lc + j
            col += 1
    return idx, kind, gpos


def _shard_rngs(rngs: Optional[RngStream], *indices: int):
    """A stream of this shard's own: one seed drawn from `rngs` with the
    shard's indices folded in (each rank draws the same base seed)."""
    if rngs is None:
        return None
    base = rngs.next()
    return RngStream(torch.Generator().manual_seed(
        comm.fold_seed(base, *indices)))


def emformer_forward_seq_sharded(p: Emformer, cfg: EmformerConfig, x,
                                 lengths, mesh: comm.Mesh,
                                 seq_axis: str = "seq",
                                 rngs: Optional[RngStream] = None,
                                 data_axis: Optional[str] = None):
    """Sequence-parallel training / offline forward (JAX's
    emformer_forward_seq_sharded).  Every rank passes the whole x (B, U +
    rc, D) and lengths (B,); U must be a multiple of S * segment for the
    axis's S ranks, with at least max_memory segments per rank.  Returns
    this rank's block of emformer_forward's output: frames
    [i * U / S, (i + 1) * U / S) of rank i of the seq axis, and with
    `data_axis` (dp x sp) only its data rank's rows of the batch.  Equal to
    emformer_forward without dropout; with `rngs` each shard folds its
    index into its seeds (a different valid draw than one process's)."""
    S = mesh.size(seq_axis)
    seg, lc, rc, M = (cfg.segment, cfg.left_context, cfg.right_context,
                      cfg.max_memory)
    U = x.shape[1] - rc
    if U % (S * seg):
        raise ValueError(f"U {U} is not a multiple of {S} shards x "
                         f"{seg}-frame segments")
    n_loc = U // S // seg
    if not cfg.use_mem or n_loc < M:
        raise ValueError("the seq-sharded forward needs the memory bank and "
                         f">= max_memory ({M}) segments per shard")
    if lc > n_loc * seg:
        raise ValueError(f"left context {lc} exceeds a shard's "
                         f"{n_loc * seg} frames")
    if data_axis is not None:
        x = comm.shard_rows(mesh, x, data_axis)
        lengths = comm.shard_rows(mesh, lengths, data_axis)
    ax = mesh.index(seq_axis)
    u_loc, rc_len = n_loc * seg, n_loc * rc
    o_frames, o_seg = ax * u_loc, ax * n_loc
    x_loc, tail = x[:, o_frames:o_frames + u_loc], x[:, U:]
    b, _, d = x_loc.shape
    h = cfg.num_heads
    hd = d // h
    dev = x.device
    rngs = _shard_rngs(rngs, ax + 1)

    # the rc blocks: the input's right halo (the last shard's is the tail)
    halo_r = comm.shift_from_right(mesh, x_loc[:, :rc], seq_axis)
    if ax == S - 1:
        # every rank runs each shift's backward, in one order
        halo_r = comm.depend(tail, halo_r) if halo_r.requires_grad \
            else tail
    ext0 = torch.cat([x_loc, halo_r], dim=1)
    rc_rows = np.concatenate([np.arange((i + 1) * seg, (i + 1) * seg + rc)
                              for i in range(n_loc)])
    rc_blocks = ext0.index_select(1, torch.as_tensor(rc_rows, device=dev))
    mems_loc = _segment_means(x_loc, seg)
    out = x_loc

    idx, kind, gpos = (torch.as_tensor(a, device=dev) for a in
                       _segment_gather_indices_local(n_loc, seg, lc, rc, M))
    utt_g = o_frames + gpos[None]
    key_valid = (((kind == 0) & (o_seg + gpos >= 0))[None]
                 | (kind == 1)[None]
                 | ((kind == 2)[None] & (utt_g >= 0)
                    & (utt_g < lengths[:, None, None])))   # (B, n_loc, ctx)
    ctx = idx.shape[1]
    nq = rc + seg + 1
    # summary rows do not attend the memory slots
    block = ((torch.arange(nq, device=dev) == nq - 1)[:, None]
             & (torch.arange(ctx, device=dev) < M)[None, :])
    visible = key_valid[:, :, None, None, :] & ~block

    for layer in p.layers:
        raw = torch.cat([rc_blocks, out], dim=1)
        ln = layer_norm(layer.ln_input, raw) if cfg.normalize_before else raw
        rc_ln, utt_ln = ln[:, :rc_len], ln[:, rc_len:]
        summary = _segment_means(utt_ln, seg)
        halo_utt = comm.shift_from_left(mesh, utt_ln[:, u_loc - lc:],
                                        seq_axis)
        halo_mem = comm.shift_from_left(mesh, mems_loc[:, n_loc - M:],
                                        seq_axis)
        ap = layer.attention
        kv = linear(ap.emb_to_key_value, torch.cat(
            [halo_mem, mems_loc, rc_ln, halo_utt, utt_ln], dim=1))
        k, v = kv.chunk(2, dim=-1)
        k_ctx = k.index_select(1, idx.reshape(-1)).reshape(b, n_loc, ctx, h,
                                                           hd)
        v_ctx = v.index_select(1, idx.reshape(-1)).reshape(b, n_loc, ctx, h,
                                                           hd)
        q = linear(ap.emb_to_query, torch.cat(
            [rc_ln.reshape(b, n_loc, rc, d), utt_ln.reshape(b, n_loc, seg, d),
             summary[:, :, None]], dim=2))
        qh = q.reshape(b, n_loc, nq, h, hd).transpose(2, 3) * (hd ** -0.5)
        scores = (qh @ k_ctx.permute(0, 1, 3, 4, 2)).float()
        probs = masked_softmax(scores, visible).to(q.dtype)
        probs = dropout(probs, cfg.attention_dropout, next_seed(rngs))
        o = (probs @ v_ctx.transpose(2, 3)).transpose(2, 3).reshape(
            b, n_loc, nq, d)
        o = linear(ap.out_proj, o)
        rc_out = o[:, :, :rc].reshape(b, rc_len, d)
        utt_out = o[:, :, rc:rc + seg].reshape(b, u_loc, d)
        mems_loc = _mem_transform(o[:, :, rc + seg:].reshape(b, n_loc, d),
                                  cfg)
        result = dropout(torch.cat([rc_out, utt_out], dim=1), cfg.dropout,
                         next_seed(rngs)) + raw
        result = _pos_ff_res(layer.pos_ff, cfg, result, rngs)
        if not cfg.normalize_before:
            result = layer_norm(layer.ln_input, result)
        out, rc_blocks = result[:, rc_len:], result[:, :rc_len]
    return layer_norm(p.final_ln, out) if cfg.normalize_before else out


# ---------------------------------------------------------------------------
# pipeline-parallel training forward (GPipe schedule over a "pipe" axis)
# ---------------------------------------------------------------------------

def keep_stage_layers(p: Emformer, mesh: comm.Mesh,
                      pipe_axis: str = "pipe") -> None:
    """Drop every layer but this rank's stage's (num_layers / P contiguous
    layers), in place: `layers` becomes a ModuleDict keyed by the global
    layer index, so the parameter names stay those of the whole model."""
    n_stage, stage = mesh.size(pipe_axis), mesh.index(pipe_axis)
    if n_stage == 1:
        return
    lpp = len(p.layers) // n_stage
    p.layers = nn.ModuleDict({str(stage * lpp + i): p.layers[stage * lpp + i]
                              for i in range(lpp)})


def stage_layers(p: Emformer, cfg: EmformerConfig, mesh: comm.Mesh,
                 pipe_axis: str = "pipe"):
    """[(global index, layer)] of this rank's stage."""
    n_stage, stage = mesh.size(pipe_axis), mesh.index(pipe_axis)
    if cfg.num_layers % n_stage:
        raise ValueError(f"{cfg.num_layers} layers do not split into "
                         f"{n_stage} stages")
    lpp = cfg.num_layers // n_stage
    if isinstance(p.layers, nn.ModuleDict):
        return [(int(k), layer) for k, layer in p.layers.items()]
    return [(stage * lpp + i, p.layers[stage * lpp + i]) for i in range(lpp)]


def microbatch_rows(B: int, n_micro: int, n_data: int, d: int) -> np.ndarray:
    """The batch rows a pipeline's data rank d takes: its block of each of
    the n_micro microbatches, in microbatch order (JAX's P(None, data)
    split of the (n_micro, B / n_micro) reshape)."""
    if B % n_micro or (B // n_micro) % n_data:
        raise ValueError(f"{B} rows do not split into {n_micro} "
                         f"microbatches over {n_data} data ranks")
    mbs = B // n_micro
    loc = mbs // n_data
    return np.concatenate([m * mbs + d * loc + np.arange(loc)
                           for m in range(n_micro)])


class _StageLayers(NamedTuple):
    layers: tuple


def run_stage(layers, cfg: EmformerConfig, out, rc_blocks, mems, lengths,
              seeds: Optional[Tuple[int, int]]):
    """A stage's layers over one microbatch; `seeds` (base seed,
    microbatch) gives each (layer, microbatch) its own dropout stream."""
    for gi, layer in layers:
        rngs = None if seeds is None else RngStream(torch.Generator(
        ).manual_seed(comm.fold_seed(seeds[0], gi + 1, seeds[1] + 1)))
        out, rc_blocks, mems = _run_layers(_StageLayers((layer,)), cfg, out,
                                           rc_blocks, mems, lengths, rngs)
    return out, rc_blocks, mems


def pipeline_ticks(mesh: comm.Mesh, pipe_axis: str, n_micro: int,
                   inject, stage_fn, finish, like: torch.Tensor):
    """The GPipe schedule of n_micro + P - 1 ticks.  At tick t the rank of
    stage s holds microbatch m = t - s (none outside [0, n_micro)): stage 0
    takes inject(m) for its input, the others what the previous stage sent
    at tick t - 1; stage_fn(act, m) runs the stage; the last stage passes
    its output to finish(act, m).  The activation (a tensor shaped like
    `like`) then hops to the next stage by a cyclic shift whose backward
    is the reverse pipeline; each shift is chained to the previous one, so
    every rank runs the shifts' backward in one order.  Returns the last
    shift's output, the anchor of this rank's chain."""
    n_stage, stage = mesh.size(pipe_axis), mesh.index(pipe_axis)
    recv = None
    # the chain's first link: a stage whose first ticks hold nothing still
    # records its shifts, so that every rank runs each one's backward
    token = (torch.zeros((), device=like.device, requires_grad=True)
             if torch.is_grad_enabled() else None)
    for t in range(n_micro + n_stage - 1):
        m = t - stage
        if 0 <= m < n_micro:
            act = inject(m) if stage == 0 else recv
            act = stage_fn(act, m)
            if stage == n_stage - 1:
                finish(act, m)
        else:
            act = recv if recv is not None else torch.zeros_like(like)
        if n_stage > 1:
            recv = token = comm.shift(mesh, act, pipe_axis, 1,
                                      cyclic=True, token=token)
    return token


def _pack(out, rc_blocks, mems):
    return torch.cat([out, rc_blocks, mems], dim=1)


def _unpack(act, U: int, rc_len: int):
    return act[:, :U], act[:, U:U + rc_len], act[:, U + rc_len:]


def emformer_forward_pipelined(p: Emformer, cfg: EmformerConfig, x, lengths,
                               mesh: comm.Mesh, pipe_axis: str = "pipe",
                               n_micro: Optional[int] = None,
                               rngs: Optional[RngStream] = None,
                               data_axis: Optional[str] = None):
    """Pipeline-parallel training / offline forward (JAX's
    emformer_forward_pipelined).  The layers split into P contiguous
    stages over the pipe axis (a stage's rank needs only its layers:
    `keep_stage_layers`); the batch into n_micro microbatches (default P)
    that flow through the stages on the GPipe schedule, the (utterance, rc
    blocks, mems) activation hopping stage to stage.  Every rank passes
    the whole x (B, U + rc, D) and lengths; with `data_axis` (dp x pp)
    each microbatch's rows split over it.  Returns, on every rank of the
    pipe axis, the output rows `microbatch_rows` names (all B rows
    without a data axis, in order), equal to emformer_forward's without
    dropout; with `rngs` each (layer, microbatch) draws its own masks.
    Differentiable: the backward runs the reverse pipeline."""
    n_stage = mesh.size(pipe_axis)
    layers = stage_layers(p, cfg, mesh, pipe_axis)
    B = x.shape[0]
    n_micro = n_micro or n_stage
    n_data = mesh.size(data_axis) if data_axis else 1
    rows = torch.as_tensor(microbatch_rows(
        B, n_micro, n_data, mesh.index(data_axis) if data_axis else 0),
        device=x.device)
    loc = rows.numel() // n_micro
    U = x.shape[1] - cfg.right_context
    idx = torch.as_tensor(_rc_gather_indices(U, cfg.segment,
                                             cfg.right_context),
                          device=x.device)
    n = _num_segs(U, cfg.segment)
    x, lengths = x.index_select(0, rows), lengths.index_select(0, rows)
    utterance = x[:, :U]
    mems0 = (_segment_means(utterance, cfg.segment)[:, :n - 1] if cfg.use_mem
             else utterance[:, :0])
    act0 = _pack(utterance, x.index_select(1, idx), mems0)
    base = None if rngs is None else rngs.next()
    outs = []

    def stage_fn(act, m):
        lens = lengths[m * loc:(m + 1) * loc]
        out = run_stage(layers, cfg, *_unpack(act, U, idx.numel()), lens,
                        None if base is None else (base, m))
        return _pack(*out)

    anchor = pipeline_ticks(
        mesh, pipe_axis, n_micro, lambda m: act0[m * loc:(m + 1) * loc],
        stage_fn, lambda act, m: outs.append(act[:, :U]), act0[:loc])
    final = torch.cat(outs) if outs else torch.zeros_like(utterance)
    final = comm.replicate_from(mesh, final, pipe_axis, n_stage - 1,
                                anchor)
    return layer_norm(p.final_ln, final) if cfg.normalize_before else final
