"""Streaming evaluator, a local SimulEval (counterpart of
simulst_tpu/stream/evaluator.py).

Drives an agent through the READ/WRITE protocol utterance by utterance,
merges the BPE units into words (a word's delay is the ms of source read
when the word is committed, i.e. when the next word-initial unit arrives),
and scores BLEU and the AL / AP / DAL latencies, with computation-aware
(_CA) variants from the wall clock.  A fused session (one call per chunk)
commits the tokens of a chunk at that chunk.  `evaluate_batched` buckets
the utterances by chunk count and streams B at a time lock-step through
a fused agent's batched session, chunk by chunk or (scan=True) each
bucket's whole session in one call; `merge_honest_ca` takes the _CA
metrics of a step-wise pass into the scanned scores.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from simulst_tpu_torch.data.vocab import EOS
from simulst_tpu_torch.decode.scoring import corpus_bleu
from simulst_tpu_torch.stream.agents import (BOW_PREFIX, READ, chunk_count,
                                             chunk_geometry_ms)

SAMPLE_RATE = 16000


def _latency(delays: List[float], src_ms: float, tgt_len: int, kind: str):
    if not delays:
        return 0.0
    d = np.asarray(delays, np.float64)
    n = len(d)
    if kind == "AP":
        return float(d.sum() / (src_ms * n))
    gamma = n / src_ms
    idx = np.arange(n)
    if kind == "AL":
        reached = d >= src_ms
        tau = int(np.argmax(reached)) if reached.any() else n - 1
        lag = d[: tau + 1] - idx[: tau + 1] / gamma
        return float(lag.mean())
    if kind == "DAL":
        g = np.maximum.accumulate(d - idx / gamma) + idx / gamma
        return float((g - idx / gamma).mean())
    raise ValueError(kind)


@dataclasses.dataclass
class Instance:
    index: int
    prediction: str
    reference: str
    delays: List[float]
    elapsed: List[float]
    source_length_ms: float
    truncated: bool = False   # a fixed buffer overflowed; output cut short

    def metrics(self) -> Dict[str, float]:
        n = max(len(self.delays), 1)
        out = {}
        for kind in ("AL", "AP", "DAL"):
            out[kind] = _latency(self.delays, self.source_length_ms, n, kind)
            out[kind + "_CA"] = _latency(self.elapsed, self.source_length_ms,
                                         n, kind)
        return out


class _WordMerger:
    """BPE units -> words, each with the delay at which it was committed.
    A word's elapsed time is the wall clock since t0 when it is committed,
    or `wall_ms` where the caller took it (the batched sessions: one
    reading per chunk, or per session when scanned), plus its delay.
    `cap`, for the batched sessions: the token buffer's room; the chunk
    that fills it ends the utterance, as a B = 1 session stops there."""

    def __init__(self, symbols, t0: float, cap: Optional[int] = None):
        self.symbols = symbols
        self.t0 = t0
        self.cap = cap
        self.n_tokens = 0
        self.words: List[str] = []
        self.delays: List[float] = []
        self.elapsed: List[float] = []
        self._buf: List[str] = []
        self.done = False          # EOS written, or the buffer full

    def flush(self, consumed: int, wall_ms: Optional[float] = None):
        if self._buf:
            w = "".join(self._buf).replace(BOW_PREFIX, "").strip()
            if w:
                delay = consumed / SAMPLE_RATE * 1000.0
                if wall_ms is None:
                    wall_ms = (time.perf_counter() - self.t0) * 1000.0
                self.words.append(w)
                self.delays.append(delay)
                self.elapsed.append(wall_ms + delay)
            self._buf.clear()

    def push(self, tok: int, consumed: int, wall_ms: Optional[float] = None):
        piece = self.symbols[tok]
        if piece.startswith(BOW_PREFIX) and self._buf:
            self.flush(consumed, wall_ms)
        self._buf.append(piece)

    def push_chunk(self, tokens, consumed: int, wall_ms: float):
        """A chunk's written tokens, up to EOS; a chunk that fills the
        token buffer flushes the last word at its own delay."""
        for tok in tokens:
            self.n_tokens += 1
            if tok == EOS:
                self.done = True
                break
            self.push(tok, consumed, wall_ms)
        if not self.done and self.cap is not None and \
                self.n_tokens >= self.cap:
            self.flush(consumed, wall_ms)
            self.done = True


def run_session(agent, waveform: np.ndarray, max_actions: int = 10000
                ) -> Tuple[List[str], List[float], List[float], bool]:
    """Drive one utterance; returns (words, delays_ms, elapsed_ms,
    truncated), truncated when a fixed streaming buffer overflowed."""
    session = agent.new_session()
    if hasattr(session, "process_chunk"):
        return _run_fused(agent, session, waveform)
    total = len(waveform)
    consumed = 0
    merger = _WordMerger(agent.vocab.symbols, time.perf_counter())
    force_read = False
    for _ in range(max_actions):
        if session.finished:
            break
        action = READ if force_read else session.policy()
        force_read = False
        if action == READ:
            if session.finished_read:
                # nothing left to read; avoid a livelock
                if session.policy() == READ:
                    break
                continue
            n = int(session.next_chunk_ms / 1000.0 * SAMPLE_RATE)
            chunk = waveform[consumed: consumed + n]
            consumed = min(consumed + n, total)
            session.push_audio(chunk, finished=consumed >= total)
        else:
            tok = session.predict()
            if tok is None:
                force_read = True
                continue
            if tok == EOS:
                break
            merger.push(tok, consumed)
    merger.flush(consumed)
    return merger.words, merger.delays, merger.elapsed, session.truncated


def _run_fused(agent, session, waveform: np.ndarray):
    """Chunk-level loop of a fused session: one call per chunk, the same
    word and delay bookkeeping (tokens committed at the chunk that wrote
    them)."""
    total = len(waveform)
    consumed = 0
    merger = _WordMerger(agent.vocab.symbols, time.perf_counter())
    while consumed < total and not session.finished:
        n = int(session.next_chunk_ms / 1000.0 * SAMPLE_RATE)
        chunk = waveform[consumed: consumed + n]
        consumed = min(consumed + n, total)
        for tok in session.process_chunk(chunk, finished=consumed >= total):
            if tok == EOS:
                break
            merger.push(tok, consumed)
    merger.flush(consumed)
    return merger.words, merger.delays, merger.elapsed, session.truncated


def evaluate(agent, utterances, references: Optional[List[str]] = None,
             log_path: Optional[str] = None) -> Dict[str, float]:
    """utterances: waveforms (fp32 in [-1, 1], or int16); returns the scores
    (BLEU and the mean latencies), SimulEval's `scores` json."""
    instances = []
    for i, wav in enumerate(utterances):
        words, delays, elapsed, trunc = run_session(agent, np.asarray(wav))
        instances.append(Instance(
            index=i, prediction=" ".join(words),
            reference=references[i] if references else "", delays=delays,
            elapsed=elapsed, source_length_ms=len(wav) / SAMPLE_RATE * 1e3,
            truncated=trunc))
    return _score_and_log(instances, bool(references), log_path,
                          mode="stepwise")


def _score_and_log(instances, have_refs: bool, log_path: Optional[str],
                   mode: str) -> Dict[str, float]:
    """Scores and the instances log; `mode` says how the _CA timings were
    taken ("stepwise": per chunk, on the wall clock; "scan": the whole
    session's wall clock for every chunk, an upper bound), in the scores
    and in every instance, so that the two are never compared as
    equals."""
    scores: Dict[str, float] = {"mode": mode}
    n_trunc = sum(1 for x in instances if x.truncated)
    scores["truncated"] = n_trunc
    if n_trunc:
        print(f"WARNING: {n_trunc}/{len(instances)} utterances overflowed a "
              "fixed streaming buffer and were cut short: raise "
              "--max-src-frames / --max-tgt-len (their scores are not "
              "trustworthy; see 'truncated' in the log)", file=sys.stderr)
    if have_refs:
        scores["BLEU"] = corpus_bleu([x.reference for x in instances],
                                     [x.prediction for x in instances])
    for kind in ("AL", "AL_CA", "AP", "AP_CA", "DAL", "DAL_CA"):
        vals = [inst.metrics()[kind] for inst in instances if inst.delays]
        scores[kind] = float(np.mean(vals)) if vals else 0.0
    if log_path:
        with open(log_path, "w") as f:
            for inst in instances:
                f.write(json.dumps({**dataclasses.asdict(inst),
                                    "mode": mode}) + "\n")
    return scores


def merge_honest_ca(scan_scores: Dict[str, float],
                    stepwise_scores: Dict[str, float]) -> Dict[str, float]:
    """BLEU, AL, AP and DAL from the scanned run, the _CA metrics from the
    chunk-by-chunk run: computation-aware latency that a whole-session
    call cannot time, with the scanned run's throughput."""
    merged = dict(scan_scores)
    for k, v in stepwise_scores.items():
        if k.endswith("_CA"):
            merged[k] = v
    merged["mode"] = "scan+stepwise_ca"
    return merged


# ---------------------------------------------------------------------------
# batched evaluation (B utterances per step)
# ---------------------------------------------------------------------------

def _run_fused_batch(agent, wavs: List[np.ndarray], n_chunks: int,
                     scan: bool = False):
    """Stream len(wavs) utterances of n_chunks chunks each lock-step
    through one batched session.  Returns each example's (words, delays,
    elapsed, truncated).

    scan=True runs the whole session in one call
    (FusedBatchSession.process_session_wavs, which stages the samples on
    the device first): the same tokens and delays, but no chunk can be
    timed, so every word's elapsed time carries the whole session's wall
    clock, the staging included (the _CA metrics are an upper bound)."""
    first_ms, steady_ms = chunk_geometry_ms(agent.cfg)
    n_first = int(first_ms / 1000.0 * SAMPLE_RATE)
    n_steady = int(steady_ms / 1000.0 * SAMPLE_RATE)
    B = len(wavs)
    t0 = time.perf_counter()
    session = agent.new_batched_session(B)
    room = session.state.tokens.shape[1] - 1
    mergers = [_WordMerger(agent.vocab.symbols, t0, room) for _ in range(B)]

    if scan:
        out = session.process_session_wavs(wavs)
        wall = (time.perf_counter() - t0) * 1000.0
        for merger, wav, chunks in zip(mergers, wavs, out):
            consumed = 0
            for c, toks in enumerate(chunks):
                consumed = min(consumed + (n_first if c == 0 else n_steady),
                               len(wav))
                if merger.done:
                    break
                merger.push_chunk(toks, consumed, wall)
            merger.flush(min(n_first + (n_chunks - 1) * n_steady, len(wav)),
                         wall)
    else:
        consumed = [0] * B
        for c in range(n_chunks):
            n = n_first if c == 0 else n_steady
            chunks = []
            for i, wav in enumerate(wavs):
                chunks.append(wav[consumed[i]: consumed[i] + n])
                consumed[i] = min(consumed[i] + n, len(wav))
            out = session.process_chunk_batch(chunks,
                                              finished=c == n_chunks - 1)
            wall = (time.perf_counter() - t0) * 1000.0
            for merger, toks, done in zip(mergers, out, consumed):
                if not merger.done:
                    merger.push_chunk(toks, done, wall)
        for merger, done in zip(mergers, consumed):
            merger.flush(done)
    trunc = session.truncated
    return [(m.words, m.delays, m.elapsed, bool(trunc[i]))
            for i, m in enumerate(mergers)]


def evaluate_batched(agent, utterances, references: Optional[List[str]] = None,
                     batch_size: int = 8, log_path: Optional[str] = None,
                     scan: bool = False) -> Dict[str, float]:
    """`evaluate` with B utterances per step: the utterances are bucketed
    by chunk count (a batch shares one chunk schedule) and streamed
    `batch_size` at a time through the agent's batched session (the agent
    must be fused).  Each example's words and delays are those of its
    B = 1 session; the _CA metrics time the batched run.  scan=True runs
    each group's whole session in one call, its samples staged just
    before it runs (the staging time counted in its _CA clock)."""
    first_ms, steady_ms = chunk_geometry_ms(agent.cfg)
    n_first = int(first_ms / 1000.0 * SAMPLE_RATE)
    n_steady = int(steady_ms / 1000.0 * SAMPLE_RATE)
    wavs = [np.asarray(w) for w in utterances]
    buckets: Dict[int, List[int]] = {}
    for i, w in enumerate(wavs):
        buckets.setdefault(chunk_count(len(w), n_first, n_steady),
                           []).append(i)
    instances: List[Optional[Instance]] = [None] * len(wavs)
    for k, idxs in sorted(buckets.items()):
        for lo in range(0, len(idxs), batch_size):
            group = idxs[lo: lo + batch_size]
            results = _run_fused_batch(agent, [wavs[i] for i in group], k,
                                       scan=scan)
            for i, (words, delays, elapsed, trunc) in zip(group, results):
                instances[i] = Instance(
                    index=i, prediction=" ".join(words),
                    reference=references[i] if references else "",
                    delays=delays, elapsed=elapsed,
                    source_length_ms=len(wavs[i]) / SAMPLE_RATE * 1e3,
                    truncated=trunc)
    return _score_and_log(instances, bool(references), log_path,
                          mode="scan" if scan else "stepwise")
