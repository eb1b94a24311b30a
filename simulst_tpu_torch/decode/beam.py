"""Beam search and greedy decoding over the incremental decoder API
(counterpart of simulst_tpu/decode/beam.py).

Python loops over decode steps in place of `lax.scan`.  Beams live in the
batch axis of the decoder state, and reordering is a gather along it.
Scoring follows fairseq: accumulated log-probs, length-normalised by
len ** lenpen when a hypothesis is finalised; EOS candidates are banked and
leave the beam; at max_len the banked hypotheses compete with the
normalised live beams.  `_top_k` breaks ties towards the lower index, as
jax.lax.top_k does, so both packages pick the same candidates.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

NEG = -1e9


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    beam_size: int = 5
    max_len: int = 200
    len_penalty: float = 1.0
    pad_idx: int = 1
    eos_idx: int = 2
    # fairseq's generation options:
    min_len: int = 1           # EOS blocked while fewer tokens than this
    unk_penalty: float = 0.0   # subtracted from the unk log-prob
    unk_idx: int = 3


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, beam, max_len) best first, PAD-padded
    scores: torch.Tensor   # (B, beam) length-normalised
    lengths: torch.Tensor  # (B, beam) lengths incl. EOS


def _top_k(x, k: int):
    """Largest k along the last axis; ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _forced(prefix_tokens, t: int, pad_idx: int):
    """(forced token (B,), has a prefix token at step t (B,)) of a PAD-padded
    (B, P) prefix."""
    p = prefix_tokens.shape[1]
    forced = prefix_tokens[:, min(t, p - 1)].long()
    if t >= p:
        forced = torch.full_like(forced, pad_idx)
    return forced, forced != pad_idx


def beam_search(step_fn: Callable, init_state, batch_size: int,
                cfg: BeamConfig, reorder_fn: Callable, prefix_tokens=None,
                device=None, bos: Optional[int] = None) -> BeamResult:
    """step_fn(state, tokens (N,)) -> (logits (N, V), state) with
    N = batch * beam, seeded with EOS (the fairseq convention) or with
    `bos` (the transducer's blank);
    reorder_fn(state, idx (N,)) -> state gathered along the batch axis.
    prefix_tokens: (B, P) PAD-padded; each hypothesis starts with its row's prefix (fairseq's --prefix-size: the
    prefix token keeps its model score, every other continuation is
    masked)."""
    bsz, beam, L = batch_size, cfg.beam_size, cfg.max_len
    n = bsz * beam
    ar_b = torch.arange(bsz, device=device)[:, None]

    tokens = torch.full((bsz, beam, L + 1), cfg.pad_idx, dtype=torch.int64,
                        device=device)
    tokens[:, :, 0] = cfg.eos_idx if bos is None else bos
    scores = torch.where(torch.arange(beam, device=device) == 0, 0.0, NEG)
    scores = scores[None].expand(bsz, beam).contiguous()
    bank_tokens = torch.full((bsz, beam, L), cfg.pad_idx, dtype=torch.int64,
                             device=device)
    bank_scores = torch.full((bsz, beam), NEG, device=device)
    bank_lengths = torch.ones((bsz, beam), dtype=torch.int64, device=device)
    state = init_state

    for t in range(L):
        logits, state = step_fn(state, tokens[:, :, t].reshape(n))
        lprobs = torch.log_softmax(logits.float(), dim=-1)
        v = lprobs.shape[-1]
        lprobs = lprobs.reshape(bsz, beam, v)
        lprobs[:, :, cfg.pad_idx] = NEG            # never produce PAD
        if cfg.unk_penalty:
            lprobs[:, :, cfg.unk_idx] -= cfg.unk_penalty
        if t < cfg.min_len:                        # block EOS until min_len
            lprobs[:, :, cfg.eos_idx] = NEG
        if prefix_tokens is not None:
            forced, has = _forced(prefix_tokens, t, cfg.pad_idx)
            keep = torch.nn.functional.one_hot(forced, v).bool()[:, None]
            masked = torch.where(keep, lprobs, torch.full_like(lprobs, NEG))
            lprobs = torch.where(has[:, None, None], masked, lprobs)

        cand = scores[:, :, None] + lprobs                      # (B, beam, V)
        k2 = min(2 * beam, beam * v)
        top_scores, top_idx = _top_k(cand.reshape(bsz, beam * v), k2)
        src_beam = top_idx // v
        tok = top_idx % v
        is_eos = tok == cfg.eos_idx

        cand_tokens = tokens[ar_b, src_beam]                    # (B, 2b, L+1)
        cand_tokens[:, :, t + 1] = tok

        # bank finished candidates with length-normalised scores
        fin_norm = max(float(t + 1) ** cfg.len_penalty, 1.0)
        fin_scores = torch.where(is_eos, top_scores / fin_norm,
                                 torch.full_like(top_scores, NEG))
        all_scores = torch.cat([bank_scores, fin_scores], dim=1)
        all_tokens = torch.cat([bank_tokens, cand_tokens[:, :, 1:]], dim=1)
        all_lengths = torch.cat([bank_lengths,
                                 torch.full_like(tok, t + 1)], dim=1)
        bank_scores, bank_idx = _top_k(all_scores, beam)
        bank_tokens = all_tokens[ar_b, bank_idx]
        bank_lengths = all_lengths.gather(1, bank_idx)

        # live beams: the best `beam` non-EOS candidates
        live_scores = torch.where(is_eos, torch.full_like(top_scores, NEG),
                                  top_scores)
        scores, live_idx = _top_k(live_scores, beam)
        tokens = cand_tokens[ar_b, live_idx]
        live_src = src_beam.gather(1, live_idx)
        state = reorder_fn(state, (ar_b * beam + live_src).reshape(n))

    # unfinished beams compete at max_len with length normalisation
    live_norm = max(float(L) ** cfg.len_penalty, 1.0)
    all_scores = torch.cat([bank_scores, scores / live_norm], dim=1)
    all_tokens = torch.cat([bank_tokens, tokens[:, :, 1:]], dim=1)
    all_lengths = torch.cat([bank_lengths,
                             torch.full_like(bank_lengths, L)], dim=1)
    final_scores, idx = _top_k(all_scores, beam)
    out_tokens = all_tokens[ar_b, idx]
    lengths = all_lengths.gather(1, idx)
    pos = torch.arange(L, device=device)[None, None, :]
    out_tokens = torch.where(pos < lengths[:, :, None], out_tokens,
                             torch.full_like(out_tokens, cfg.pad_idx))
    return BeamResult(tokens=out_tokens, scores=final_scores, lengths=lengths)


def greedy_decode(step_fn: Callable, init_state, batch_size: int,
                  cfg: BeamConfig, prefix_tokens=None, device=None,
                  bos: Optional[int] = None):
    """Greedy (beam 1) decode seeded with EOS, or with `bos`;
    prefix_tokens (B, P), PAD-padded, forces each row's first tokens.
    Returns (tokens (B, max_len), lengths (B,))."""
    tokens = torch.full((batch_size, cfg.max_len), cfg.pad_idx,
                        dtype=torch.int64, device=device)
    prev = torch.full((batch_size,), cfg.eos_idx if bos is None else bos,
                      dtype=torch.int64, device=device)
    done = torch.zeros(batch_size, dtype=torch.bool, device=device)
    state = init_state
    for t in range(cfg.max_len):
        logits, state = step_fn(state, prev)
        lg = logits.float()
        if cfg.unk_penalty:
            lg[:, cfg.unk_idx] -= cfg.unk_penalty
        if t < cfg.min_len:
            lg[:, cfg.eos_idx] = NEG
        nxt = lg.argmax(dim=-1)
        if prefix_tokens is not None:
            forced, has = _forced(prefix_tokens, t, cfg.pad_idx)
            nxt = torch.where(has, forced, nxt)
        nxt = torch.where(done, torch.full_like(nxt, cfg.pad_idx), nxt)
        tokens[:, t] = nxt
        done = done | (nxt == cfg.eos_idx)
        prev = nxt
    is_eos = tokens == cfg.eos_idx
    first = torch.argmax(is_eos.int(), dim=-1) + 1
    lengths = torch.where(is_eos.any(dim=-1), first,
                          torch.full_like(first, cfg.max_len))
    return tokens, lengths
