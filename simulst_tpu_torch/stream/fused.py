"""Per-chunk streaming steps of the CIF, MMA and transducer policies: READ
+ every WRITE of one audio chunk in one call (counterpart of
simulst_tpu/stream/fused.py).

One call runs the incremental encoder on a chunk for B utterances in
lock-step, then keeps decoding until every example's policy demands more
source, emits EOS, or rejects a premature EOS (before the final chunk),
with per-example rollback.  CIF: the new encoder frames go through the
streaming CIF layer and its fired features are appended to each example's
CIF buffer; an example WRITEs while its fired length exceeds its decoded
length, or once the source is complete.  MMA: the frames are appended to
each example's encoder buffer and the model decides (any monotonic head
demanding source is a READ); an example that does not WRITE keeps its old
KV caches and step and adopts only its advanced monotonic head positions.
Transducer: the frames are appended to each example's encoder buffer, and
each attempt scans the visible frames from the last emit for the first
non-blank prediction; an all-blank attempt is a READ and is not adopted.
The JAX steps are one lax.while_loop on the device; here the loop is
Python over `cif_decoder_step` / `mma_decoder_step` / the transducer's
`decode_step` calls, with one host read of "anyone still writing" per
attempt.

Batches: the utterances of a chunk-count bucket run lock-step on one chunk
schedule; on the final chunk each example passes its own count of valid
feature frames (`n_valid`; the shorter ones zero-padded by the caller).
For evaluation, where the whole audio is known, `make_scanned_runner`
runs a bucket's whole session in one call: the JAX package's lax.scan
over the steady chunks is a Python loop over the same step here, token
for token the per-chunk loop's.

Several cards (`sharded_sessions`): the B sessions of a batch split over
the data ranks of a mesh (comm.py), each rank streaming its B / W
sessions, and the tokens and counts are gathered; the JAX package shards
the same batch over a data mesh axis.  The sessions never interact, so
each one's tokens are those of the single-process batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from simulst_tpu_torch import comm
from simulst_tpu_torch.models import cif as cif_mod
from simulst_tpu_torch.models import mma as mma_mod
from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.models import transducer as tr


def _where_b(mask, new, old):
    """Per-example select over batch-leading tensors in nested tuples;
    mask: (B,) bool.  A tensor that both sides share (a KV buffer written
    in place) is kept as it is."""
    if isinstance(new, tuple):
        parts = [_where_b(mask, n, o) for n, o in zip(new, old)]
        return type(new)(*parts) if hasattr(new, "_fields") else tuple(parts)
    if new is old:
        return new
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def _append_rows(buf, buf_len, new, n_new):
    """Masked per-example append: new[i, :n_new[i]] goes to buf[i,
    buf_len[i]:].  buf: (B, Tmax, D); new: (B, c, D).  Returns (buf,
    buf_len, overflow): rows past the capacity are dropped, buf_len is
    clamped at Tmax, and overflow (B,) says which examples lost rows."""
    tmax = buf.shape[1]
    if new.shape[1] == 0:
        return buf, buf_len, torch.zeros_like(buf_len, dtype=torch.bool)
    pos = torch.arange(tmax, device=buf.device)[None, :]
    new_idx = pos - buf_len[:, None]                 # slot within `new`
    take = (new_idx >= 0) & (new_idx < n_new[:, None])
    gathered = new.gather(1, torch.clamp(new_idx, 0, new.shape[1] - 1)[
        :, :, None].expand(-1, -1, new.shape[2]))
    out = torch.where(take[:, :, None], gathered.to(buf.dtype), buf)
    want = buf_len + n_new.to(buf_len.dtype)
    return out, torch.clamp(want, max=tmax), want > tmax


def _prev_tokens(tokens, n_tok, start: int):
    """Each example's last written token, `start` (EOS; the transducer's
    blank) before the first."""
    last = tokens.gather(1, torch.clamp(n_tok - 1, min=0)[:, None])[:, 0]
    return torch.where(n_tok > 0, last, torch.full_like(last, start))


class CIFFusedState(NamedTuple):
    enc: s2t.EncoderStreamState
    cif: cif_mod.CIFStreamState
    dec: cif_mod.CIFDecoderState
    cif_buf: torch.Tensor                # (B, Tmax, D) fired features
    cif_len: torch.Tensor                # (B,) int64
    tokens: torch.Tensor                 # (B, Tmax) int64 written so far
    n_tokens: torch.Tensor               # (B,) int64
    finished: torch.Tensor               # (B,) bool: EOS written
    truncated: torch.Tensor              # (B,) bool: a buffer overflowed


def cif_fused_init(model: cif_mod.CIFModel, cfg: cif_mod.CIFConfig,
                   max_tokens: int, batch: int = 1, dtype=None,
                   device=None) -> CIFFusedState:
    device = device or next(model.parameters()).device
    dtype = cfg.dtype if dtype is None else dtype
    return CIFFusedState(
        enc=s2t.encoder_init_state(model.encoder, cfg, batch, dtype, device),
        cif=cif_mod.cif_layer_init_state(model.cif, cfg, batch, dtype,
                                         device),
        dec=cif_mod.cif_decoder_init_state(cfg, batch, max_tokens, dtype,
                                           device),
        cif_buf=torch.zeros(batch, max_tokens, cfg.embed_dim, dtype=dtype,
                            device=device),
        cif_len=torch.zeros(batch, dtype=torch.int64, device=device),
        tokens=torch.full((batch, max_tokens), cfg.padding_idx,
                          dtype=torch.int64, device=device),
        n_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        truncated=torch.zeros(batch, dtype=torch.bool, device=device))


def make_cif_fused_step(model: cif_mod.CIFModel, cfg: cif_mod.CIFConfig,
                        overshoot_weight: float = 1.0,
                        max_writes_per_chunk: int = 64):
    """Returns step(state, feats, finish=False) -> (state, n_new): the
    encoder step on feats (B, f, F) (or None) and the streaming CIF layer
    on its output, then the WRITE loop; at most max_writes_per_chunk
    attempts mid-stream, up to the token buffer on the final chunk.  `cfg`
    may differ from model.cfg (a test-time cif_beta).  n_valid, on the
    final chunk only: (B,) each example's count of valid frames in feats;
    its frames past them reach neither the encoder's state nor the CIF
    layer's alphas."""

    @torch.no_grad()
    def step(state: CIFFusedState, feats, finish: bool = False,
             n_valid: Optional[torch.Tensor] = None
             ) -> Tuple[CIFFusedState, torch.Tensor]:
        enc_out, enc_state = s2t.encoder_step(model.encoder, cfg, state.enc,
                                              feats, finish, n_valid)
        fired, n_emit, cif_state = cif_mod.cif_layer_step(
            model.cif, cfg, state.cif, enc_out.encoder_out, finish,
            x_valid=enc_out.lengths if n_valid is not None else None)
        cif_buf, cif_len, overflow = _append_rows(
            state.cif_buf, state.cif_len, fired, n_emit)
        b, tmax = state.tokens.shape
        pos = torch.arange(tmax, device=cif_len.device)[None, :]
        cap = (tmax - 1) if finish else max_writes_per_chunk

        dec, tokens, n_tok, finished = (state.dec, state.tokens,
                                        state.n_tokens, state.finished)
        stopped = torch.zeros_like(finished)
        for _ in range(cap):
            # WRITE while the fired length exceeds the decoded length, or
            # once the source is complete
            want = (cif_len > n_tok) | finish
            active = ~finished & ~stopped & want & (n_tok < tmax - 1)
            if not bool(active.any()):
                break
            logits, new_dec = cif_mod.cif_decoder_step(
                model.decoder, cfg, dec, _prev_tokens(tokens, n_tok,
                                                      cfg.eos_idx),
                cif_buf, cif_len, overshoot_weight=overshoot_weight)
            tok = logits.argmax(-1)
            is_eos = tok == cfg.eos_idx
            # EOS before the final chunk: discard that example's attempt
            reject = is_eos & (not finish)
            accept = active & ~reject
            dec = _where_b(accept, new_dec, dec)
            tokens = torch.where((pos == n_tok[:, None]) & accept[:, None],
                                 tok[:, None], tokens)
            n_tok = n_tok + accept.long()
            finished = finished | (accept & is_eos)
            stopped = stopped | (active & reject)
        trunc = state.truncated | overflow | (~finished & (n_tok >= tmax - 1))
        new_state = CIFFusedState(enc=enc_state, cif=cif_state, dec=dec,
                                  cif_buf=cif_buf, cif_len=cif_len,
                                  tokens=tokens, n_tokens=n_tok,
                                  finished=finished, truncated=trunc)
        return new_state, n_tok - state.n_tokens

    return step


class MMAFusedState(NamedTuple):
    enc: s2t.EncoderStreamState
    dec: mma_mod.MMADecoderState
    enc_buf: torch.Tensor                # (B, Smax, D)
    src_len: torch.Tensor                # (B,) int64
    tokens: torch.Tensor                 # (B, Tmax) int64
    n_tokens: torch.Tensor               # (B,) int64
    finished: torch.Tensor               # (B,) bool
    truncated: torch.Tensor              # (B,) bool: a buffer overflowed


def mma_fused_init(model: mma_mod.MMAModel, cfg: mma_mod.MMAConfig,
                   max_src: int, max_tokens: int, batch: int = 1,
                   dtype=None, device=None) -> MMAFusedState:
    device = device or next(model.parameters()).device
    dtype = cfg.dtype if dtype is None else dtype
    return MMAFusedState(
        enc=s2t.encoder_init_state(model.encoder, cfg, batch, dtype, device),
        dec=mma_mod.mma_decoder_init_state(cfg, batch, max_tokens, dtype,
                                           device),
        enc_buf=torch.zeros(batch, max_src, cfg.embed_dim, dtype=dtype,
                            device=device),
        src_len=torch.zeros(batch, dtype=torch.int64, device=device),
        tokens=torch.full((batch, max_tokens), cfg.padding_idx,
                          dtype=torch.int64, device=device),
        n_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        truncated=torch.zeros(batch, dtype=torch.bool, device=device))


def make_mma_fused_step(model: mma_mod.MMAModel, cfg: mma_mod.MMAConfig,
                        max_writes_per_chunk: int = 64):
    """Returns step(state, feats, finish=False) -> (state, n_new): the
    encoder step on feats (B, f, F) (or None), then the WRITE loop until
    every example READs, emits EOS or rejects a premature EOS; at most
    max_writes_per_chunk attempts mid-stream, up to the token buffer on
    the final chunk.  n_valid, on the final chunk only: (B,) each
    example's count of valid frames in feats; only its valid encoder
    frames reach its buffer."""

    @torch.no_grad()
    def step(state: MMAFusedState, feats, finish: bool = False,
             n_valid: Optional[torch.Tensor] = None
             ) -> Tuple[MMAFusedState, torch.Tensor]:
        enc_out, enc_state = s2t.encoder_step(model.encoder, cfg, state.enc,
                                              feats, finish, n_valid)
        enc_buf, src_len, overflow = _append_rows(
            state.enc_buf, state.src_len, enc_out.encoder_out,
            enc_out.lengths)
        b, tmax = state.tokens.shape
        dev = state.tokens.device
        pos = torch.arange(tmax, device=dev)[None, :]
        cap = (tmax - 1) if finish else max_writes_per_chunk

        dec, tokens, n_tok, finished = (state.dec, state.tokens,
                                        state.n_tokens, state.finished)
        stopped = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(cap):
            attempted = ~finished & ~stopped & (n_tok < tmax - 1)
            if not bool(attempted.any()):
                break
            logits, action, new_dec = mma_mod.mma_decoder_step(
                model.decoder, cfg, dec, _prev_tokens(tokens, n_tok,
                                                      cfg.eos_idx),
                enc_buf, src_len, online=not finish)
            tok = logits.argmax(-1)
            is_eos = tok == cfg.eos_idx
            read = attempted & (action == 0)
            premature = is_eos & (not finish)
            reject = attempted & (action == 1) & premature
            write = attempted & (action == 1) & ~premature
            # rollback (READ or rejected EOS): keep the old KV counts and
            # step, adopt the advanced monotonic positions; examples not
            # attempted keep everything
            rolled = mma_mod.adopt_on_read(dec, new_dec)
            dec = _where_b(write, new_dec, _where_b(attempted, rolled, dec))
            tokens = torch.where((pos == n_tok[:, None]) & write[:, None],
                                 tok[:, None], tokens)
            n_tok = n_tok + write.long()
            finished = finished | (write & is_eos)
            stopped = stopped | read | reject | (write & is_eos)
        # truncated: a buffer overflowed, or the token buffer filled before
        # EOS (n_tok reaches tmax - 1 only by using every writable slot)
        trunc = state.truncated | overflow | (~finished & (n_tok >= tmax - 1))
        new_state = MMAFusedState(enc=enc_state, dec=dec, enc_buf=enc_buf,
                                  src_len=src_len, tokens=tokens,
                                  n_tokens=n_tok, finished=finished,
                                  truncated=trunc)
        return new_state, n_tok - state.n_tokens

    return step


class TransducerFusedState(NamedTuple):
    enc: s2t.EncoderStreamState
    dec: tr.TransducerState
    enc_buf: torch.Tensor                # (B, Smax, D) raw encoder frames
    src_len: torch.Tensor                # (B,) int64
    tokens: torch.Tensor                 # (B, Tmax) int64
    n_tokens: torch.Tensor               # (B,) int64
    finished: torch.Tensor               # (B,) bool
    truncated: torch.Tensor              # (B,) bool: a buffer overflowed


def transducer_fused_init(model: tr.TransducerModel,
                          cfg: tr.TransducerConfig, max_src: int,
                          max_tokens: int, batch: int = 1,
                          dtype=None,
                          device=None) -> TransducerFusedState:
    device = device or next(model.parameters()).device
    dtype = cfg.dtype if dtype is None else dtype
    return TransducerFusedState(
        enc=s2t.encoder_init_state(model.encoder, cfg, batch, dtype, device),
        dec=tr.init_decode_state(cfg, batch, max_tokens, dtype, device),
        enc_buf=torch.zeros(batch, max_src, cfg.embed_dim, dtype=dtype,
                            device=device),
        src_len=torch.zeros(batch, dtype=torch.int64, device=device),
        tokens=torch.full((batch, max_tokens), cfg.padding_idx,
                          dtype=torch.int64, device=device),
        n_tokens=torch.zeros(batch, dtype=torch.int64, device=device),
        finished=torch.zeros(batch, dtype=torch.bool, device=device),
        truncated=torch.zeros(batch, dtype=torch.bool, device=device))


def make_transducer_fused_step(model: tr.TransducerModel,
                               cfg: tr.TransducerConfig,
                               max_writes_per_chunk: int = 64):
    """Returns step(state, feats, finish=False) -> (state, n_new): the
    encoder step on feats (B, f, F) (or None), then the greedy emit loop
    until every example READs (every visible frame blank), emits EOS or
    rejects a premature EOS; neither a READ nor a rejected EOS is adopted.
    At most max_writes_per_chunk attempts mid-stream, up to the token
    buffer on the final chunk, where the emit at the source's last frame
    is forced.  n_valid, on the final chunk only: (B,) each example's count
    of valid frames in feats; only its valid encoder frames reach its
    buffer."""

    @torch.no_grad()
    def step(state: TransducerFusedState, feats, finish: bool = False,
             n_valid: Optional[torch.Tensor] = None
             ) -> Tuple[TransducerFusedState, torch.Tensor]:
        enc_out, enc_state = s2t.encoder_step(model.encoder, cfg, state.enc,
                                              feats, finish, n_valid)
        enc_buf, src_len, overflow = _append_rows(
            state.enc_buf, state.src_len, enc_out.encoder_out,
            enc_out.lengths)
        b, tmax = state.tokens.shape
        dev = state.tokens.device
        pos = torch.arange(tmax, device=dev)[None, :]
        cap = (tmax - 1) if finish else max_writes_per_chunk

        dec, tokens, n_tok, finished = (state.dec, state.tokens,
                                        state.n_tokens, state.finished)
        stopped = torch.zeros(b, dtype=torch.bool, device=dev)
        for _ in range(cap):
            attempted = ~finished & ~stopped & (n_tok < tmax - 1)
            if not bool(attempted.any()):
                break
            logits, emitted, new_dec = tr.decode_step(
                model.decoder, cfg, dec,
                _prev_tokens(tokens, n_tok, cfg.blank_idx), enc_buf,
                src_len, online=not finish)
            tok = logits.argmax(-1)
            is_eos = tok == cfg.eos_idx
            read = attempted & ~emitted
            premature = is_eos & (not finish)
            reject = attempted & emitted & premature
            write = attempted & emitted & ~premature
            dec = _where_b(write, new_dec, dec)
            tokens = torch.where((pos == n_tok[:, None]) & write[:, None],
                                 tok[:, None], tokens)
            n_tok = n_tok + write.long()
            finished = finished | (write & is_eos)
            stopped = stopped | read | reject | (write & is_eos)
        trunc = state.truncated | overflow | (~finished & (n_tok >= tmax - 1))
        new_state = TransducerFusedState(
            enc=enc_state, dec=dec, enc_buf=enc_buf, src_len=src_len,
            tokens=tokens, n_tokens=n_tok, finished=finished,
            truncated=trunc)
        return new_state, n_tok - state.n_tokens

    return step


# ---------------------------------------------------------------------------
# whole sessions
# ---------------------------------------------------------------------------

def drain_writes(state, step_fn, max_rounds: int = 64):
    """WRITEs still pending after the final chunk (each step caps its
    attempts): step again with no new features until every example is
    finished or full, or a round writes nothing."""
    for _ in range(max_rounds):
        full = state.n_tokens >= state.tokens.shape[1] - 1
        if bool((state.finished | full).all()):
            break
        state, n_new = step_fn(state, None, finish=True)
        if int(n_new.sum()) == 0:
            break
    return state


def make_scanned_runner(step_fn):
    """run(state, first, mid, last, last_valid=None) -> (state, counts):
    first (B, c0, F) the first chunk's features; mid (N, B, c, F) the
    steady chunks (N may be 0, or mid None); last (B, cl, F) the final
    chunk (or None: a flush with no new features), with `last_valid` its
    per-example valid counts; then the drain.  Returns the final state and
    the per-chunk written-token counts (N + 2, B), the drained tokens
    counted with the final chunk.  Token for token the per-chunk loop's
    (the same step)."""

    def run(state, first, mid, last, last_valid=None):
        counts = []
        state, n = step_fn(state, first)
        counts.append(n)
        for feats in (mid if mid is not None else ()):
            state, n = step_fn(state, feats)
            counts.append(n)
        before = state.n_tokens
        state, _ = step_fn(state, last, finish=True, n_valid=last_valid)
        state = drain_writes(state, step_fn)
        counts.append(state.n_tokens - before)
        return state, torch.stack(counts)

    return run



def sharded_sessions(mesh: comm.Mesh, run_local, tensors):
    """B sessions over the data ranks: run_local(*local) -> the final
    fused state (CIF, MMA or transducer) of this rank's rows of every
    batch-leading tensor in `tensors` (feature chunks, valid counts).
    Returns (tokens (B, Tmax), n_tokens, finished, truncated), gathered in
    batch order on every rank."""
    local = [None if t is None else comm.shard_rows(mesh, t, "data")
             for t in tensors]
    state = run_local(*local)
    return tuple(comm.all_gather_nograd(mesh, t, "data") for t in
                 (state.tokens, state.n_tokens, state.finished,
                  state.truncated))
