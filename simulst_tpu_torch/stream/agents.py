"""Streaming READ/WRITE agents (counterpart of simulst_tpu/stream/agents.py).

Every READ runs the incremental encoder on one chunk of audio, every WRITE
attempt one decoder step over a fixed-capacity buffer; rolling back a READ
is keeping the old decoder state.

Protocol (the reference's chunk geometry, `chunk_geometry_ms`): the first
READ takes (segment + right_context) x 10 ms of audio plus one 15 ms
window, each later READ segment x 10 ms.
  * MMA / wait-k: the decoder runs each step and the model decides (any
    monotonic head demanding source is a READ);
  * CIF: WRITE iff the fired CIF length exceeds the decoded length, or the
    source is complete;
  * transducer: each attempt scans the visible frames from the last emit
    for the first non-blank prediction; all blank is a READ (the attempt
    is not adopted), and once the source is complete the emit at its last
    frame is forced;
  * with force_finish, an EOS predicted before the source is complete is
    discarded and the agent READs instead.
A fused agent (`fused=True`) runs READ and every WRITE of a chunk in one
call of stream/fused.py's step through `FusedChunkSession`, and streams
B utterances of one chunk-count bucket lock-step through one step per
chunk through `FusedBatchSession` (`new_batched_session`), or runs their
whole session from the waveforms in one call (`process_session_wavs`).
Every session builds its own state: the KV caches and the Emformer memory
are written in place, so sessions cannot share one.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from simulst_tpu_torch.data.vocab import EOS, Vocabulary
from simulst_tpu_torch.models import cif as cif_mod
from simulst_tpu_torch.models import mma as mma_mod
from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.models import transducer as tr
from simulst_tpu_torch.ops.fbank import OnlineFbank, fbank_batch, num_frames
from simulst_tpu_torch.stream import fused as fused_steps

READ, WRITE = 0, 1
BOW_PREFIX = "▁"  # sentencepiece word-start marker


@dataclasses.dataclass
class AgentConfig:
    max_src_frames: int = 1024      # encoder buffer capacity (subsampled)
    max_tgt_len: int = 256
    force_finish: bool = True
    overshoot_weight: float = 1.0   # CIF's EOS overshoot bias
    max_len_factor: float = 10.0    # unread, as in the JAX package


def chunk_geometry_ms(cfg) -> tuple:
    """(first_chunk_ms, steady_chunk_ms)."""
    stride_ms = cfg.stride * 10
    first = (cfg.segment_length // cfg.stride
             + cfg.right_context // cfg.stride) * stride_ms + 15
    steady = (cfg.segment_length // cfg.stride) * stride_ms
    return first, steady


class StreamingSession:
    """One utterance's step-wise streaming state; subclasses implement
    policy and predict."""

    def __init__(self, agent):
        self.agent = agent
        cfg, dev = agent.cfg, agent.device
        self.fbank = OnlineFbank(global_cmvn=agent.global_cmvn)
        self.enc_state = s2t.encoder_init_state(agent.model.encoder, cfg, 1,
                                                device=dev)
        self.enc_buf = torch.zeros(1, agent.acfg.max_src_frames,
                                   cfg.embed_dim, dtype=cfg.dtype, device=dev)
        self.src_len = 0
        self.finished_read = False
        self.finished = False
        self.truncated = False
        self.target_ids: List[int] = []
        self.first_chunk_ms, self.chunk_ms = chunk_geometry_ms(cfg)
        self.next_chunk_ms = self.first_chunk_ms
        self._got_first = False

    # -- source side ---------------------------------------------------------
    @torch.no_grad()
    def push_audio(self, samples: np.ndarray, finished: bool):
        """Feed raw samples (in [-1, 1], or int16); runs the encoder on the
        new chunk."""
        feats = self.fbank(samples)
        self.finished_read = self.finished_read or finished
        if feats.shape[0] == 0 and not finished:
            return
        x = (torch.from_numpy(feats)[None].to(self.agent.device)
             if feats.shape[0] > 0 else None)
        out, self.enc_state = self.agent.enc_step(self.enc_state, x,
                                                  finish=finished)
        n = out.encoder_out.shape[1]
        if n > 0:
            room = self.enc_buf.shape[1] - self.src_len
            if n > room:
                # the buffer is full: stop encoding past it, and say so
                self.truncated = True
                n = max(room, 0)
                out = out._replace(encoder_out=out.encoder_out[:, :n])
            if n > 0:
                self.enc_buf[:, self.src_len:self.src_len + n] = \
                    out.encoder_out
                self._consume_encoder_extra(out)
                self.src_len += n
        self.next_chunk_ms = self.chunk_ms
        self._got_first = True

    def _consume_encoder_extra(self, out):
        pass

    # -- target side ---------------------------------------------------------
    def policy(self) -> int:
        raise NotImplementedError

    def predict(self) -> Optional[int]:
        raise NotImplementedError

    def _commit(self, idx: int):
        self.target_ids.append(idx)
        if idx == EOS or len(self.target_ids) >= \
                self.agent.acfg.max_tgt_len - 1:
            if idx != EOS:
                self.truncated = True   # the token buffer filled before EOS
            self.finished = True


class SpeechAgent:
    """The model (on its device), its config and the step functions that
    the sessions share."""

    session_cls = StreamingSession

    def __init__(self, model, vocab: Vocabulary,
                 acfg: Optional[AgentConfig] = None, global_cmvn=None,
                 cfg=None):
        self.model = model
        self.cfg = cfg or model.cfg
        self.vocab = vocab
        self.acfg = acfg or AgentConfig()
        self.global_cmvn = global_cmvn
        self.device = next(model.parameters()).device
        self.enc_step = s2t.make_encoder_stepper(model.encoder, self.cfg)
        self.fused = False

    def new_session(self):
        if self.fused:
            return FusedChunkSession(self, self._fused_init(1),
                                     self._fused_step)
        return self.session_cls(self)

    def new_batched_session(self, batch: int) -> "FusedBatchSession":
        if not self.fused:
            raise ValueError("batched streaming requires fused=True")
        return FusedBatchSession(self, self._fused_init(batch),
                                 self._fused_step, batch)


class FusedChunkSession:
    """A session that runs one fused step (stream/fused.py) per audio
    chunk: READ and every WRITE of the chunk in one call."""

    def __init__(self, agent, state, step_fn):
        self.agent = agent
        self.fbank = OnlineFbank(global_cmvn=agent.global_cmvn)
        self.state = state
        self.step_fn = step_fn
        self.first_chunk_ms, self.chunk_ms = chunk_geometry_ms(agent.cfg)
        self.next_chunk_ms = self.first_chunk_ms
        self.finished = False

    def process_chunk(self, samples: np.ndarray, finished: bool) -> List[int]:
        feats = self.fbank(samples)
        x = (torch.from_numpy(feats)[None].to(self.agent.device)
             if feats.shape[0] > 0 else None)
        n_before = int(self.state.n_tokens[0])
        self.state, _ = self.step_fn(self.state, x, finish=finished)
        if finished:
            self.state = fused_steps.drain_writes(self.state, self.step_fn)
        self.next_chunk_ms = self.chunk_ms
        n_after = int(self.state.n_tokens[0])
        self.finished = bool(self.state.finished[0]) or \
            n_after >= self.state.tokens.shape[1] - 1
        return self.state.tokens[0, n_before:n_after].tolist()

    @property
    def truncated(self) -> bool:
        return bool(self.state.truncated[0])


def chunk_count(n_samples: int, first: int, steady: int) -> int:
    """Chunks that stream n_samples: the first of `first` samples, then
    `steady` at a time."""
    consumed, k = 0, 0
    while consumed < n_samples:
        consumed = min(consumed + (first if k == 0 else steady), n_samples)
        k += 1
    return k


def _session_schedule(cfg, wavs):
    """The lock-step schedule of a bucket: (n_first, n_steady, n_chunks,
    sched_samples).  Every wav must have the same chunk count."""
    first_ms, steady_ms = chunk_geometry_ms(cfg)
    n_first = int(first_ms / 1000.0 * 16000)
    n_steady = int(steady_ms / 1000.0 * 16000)
    n_chunks = chunk_count(len(wavs[0]), n_first, n_steady)
    if any(chunk_count(len(w), n_first, n_steady) != n_chunks for w in wavs):
        raise ValueError("a lock-step bucket must share the chunk count")
    return n_first, n_steady, n_chunks, n_first + (n_chunks - 1) * n_steady


class StagedWavs(NamedTuple):
    wav_mat: torch.Tensor            # (B, sched) fp32 or int16, on the device
    n_valid: Optional[torch.Tensor]  # (B,) final-chunk frame counts, or None


def stage_session_wavs(agent, wavs) -> Optional[StagedWavs]:
    """The (B, sched) sample matrix of a bucket, zero-padded, and the
    per-example final-chunk frame counts, on the agent's device.  int16 PCM
    stays int16 (a quarter of fp32's bytes; the featurizer's cast is
    exact); a bucket that mixes int16 and float wavs is staged as fp32 in
    [-1, 1].  n_valid is None when every final count is the schedule's.
    A single-chunk bucket needs no staging (None)."""
    n_first, n_steady, n_chunks, sched = _session_schedule(agent.cfg, wavs)
    if n_chunks < 2:
        return None
    dt = (np.int16 if all(np.asarray(w).dtype == np.int16 for w in wavs)
          else np.float32)
    wav_mat = np.zeros((len(wavs), sched), dt)
    for i, w in enumerate(wavs):
        w = np.asarray(w)
        if dt == np.float32 and w.dtype == np.int16:
            # the featurizer scales float input by 2**15: int16 members of
            # a mixed bucket drop to [-1, 1] here
            w = w.astype(np.float32) / 32768.0
        wav_mat[i, :len(w)] = w
    before_last = n_first + (n_chunks - 2) * n_steady
    last_counts = np.array([num_frames(min(sched, len(w)))
                            - num_frames(min(before_last, len(w)))
                            for w in wavs])
    mx_last = num_frames(sched) - num_frames(before_last)
    dev = agent.device
    n_valid = (torch.from_numpy(last_counts).to(dev)
               if (last_counts != mx_last).any() else None)
    return StagedWavs(wav_mat=torch.from_numpy(wav_mat).to(dev),
                      n_valid=n_valid)


def _stack_feats(feats: List[np.ndarray], n_feat: int, device):
    """Per-example (t_i, F) features -> ((B, max t, F) zero-padded on the
    device, or None when empty; the counts t_i)."""
    counts = np.array([f.shape[0] for f in feats])
    mx = int(counts.max())
    if mx == 0:
        return None, counts
    x = np.zeros((len(feats), mx, n_feat), np.float32)
    for i, f in enumerate(feats):
        x[i, :f.shape[0]] = f
    return torch.from_numpy(x).to(device), counts


def featurize(wav_mat, global_cmvn, c0: int, cs: int, n_mid: int, mx: int):
    """(first, mid, last): the fbank of a (B, samples) matrix on its device
    (ops/fbank.fbank_batch; int16 PCM cast there), global CMVN, sliced
    into the first chunk's c0 frames, n_mid steady chunks of cs (n_mid, B,
    cs, F), or None, and the final chunk's mx."""
    w = wav_mat.float()
    if wav_mat.dtype != torch.int16:
        w = w * (2 ** 15)        # int16 PCM already is wav x 2**15
    feats = fbank_batch(w)
    if global_cmvn is not None:
        mean, std = (torch.as_tensor(np.asarray(a, np.float32),
                                     device=feats.device)
                     for a in global_cmvn)
        feats = (feats - mean) / std
    b, f = feats.shape[0], feats.shape[-1]
    mid = None
    if n_mid > 0:
        mid = feats[:, c0:c0 + n_mid * cs].reshape(
            b, n_mid, cs, f).transpose(0, 1)
    end = c0 + n_mid * cs
    return feats[:, :c0], mid, feats[:, end:end + mx]


class FusedBatchSession:
    """B utterances of one chunk-count bucket streamed lock-step through
    one fused step per chunk (stream/evaluator.evaluate_batched makes the
    buckets); on the final chunk each example passes its own count of
    valid frames.  The reference's agents take one utterance at a time."""

    def __init__(self, agent, state, step_fn, batch: int):
        self.agent = agent
        self.batch = batch
        self.fbanks = [OnlineFbank(global_cmvn=agent.global_cmvn)
                       for _ in range(batch)]
        self.state = state
        self.step_fn = step_fn
        self.first_chunk_ms, self.chunk_ms = chunk_geometry_ms(agent.cfg)
        self.next_chunk_ms = self.first_chunk_ms

    @property
    def truncated(self) -> np.ndarray:
        """(B,) bool: a fixed buffer filled and output was cut short."""
        return self.state.truncated.cpu().numpy()

    def process_chunk_batch(self, chunks: List[np.ndarray], finished: bool
                            ) -> List[List[int]]:
        """chunks: each example's NEW samples (of one size but on the final
        chunk).  Returns each example's newly written tokens."""
        feats = [fb(c) for fb, c in zip(self.fbanks, chunks)]
        x, counts = _stack_feats(feats, self.agent.cfg.input_feat,
                                 self.agent.device)
        n_valid = None
        if finished and x is not None and (counts != counts.max()).any():
            n_valid = torch.from_numpy(counts).to(self.agent.device)
        elif not finished and (counts != counts.max()).any():
            raise ValueError("mid-stream chunks must align across the batch")
        n_before = self.state.n_tokens.cpu().numpy()
        self.state, _ = self.step_fn(self.state, x, finish=finished,
                                     n_valid=n_valid)
        if finished:
            self.state = fused_steps.drain_writes(self.state, self.step_fn)
        self.next_chunk_ms = self.chunk_ms
        n_after = self.state.n_tokens.cpu().numpy()
        toks = self.state.tokens.cpu().numpy()
        return [toks[i, n_before[i]:n_after[i]].tolist()
                for i in range(self.batch)]

    def _unpack_counts(self, n_before, counts, n_chunks):
        """Each example's tokens per chunk from the (n_chunks, B) written
        counts: one cumsum, then numpy slices."""
        counts = counts.cpu().numpy()
        toks = self.state.tokens.cpu().numpy()
        ends = n_before[None, :] + np.cumsum(counts, axis=0)
        starts = ends - counts
        return [[toks[i, starts[k, i]:ends[k, i]].tolist()
                 for k in range(n_chunks)] for i in range(self.batch)]

    def process_session_wavs(self, wavs: List[np.ndarray]
                             ) -> List[List[List[int]]]:
        """The whole session from raw waveforms (fp32 in [-1, 1] or int16
        PCM) in one call: the bucket staged on the device
        (`stage_session_wavs`), the fbank of its (B, sched) sample matrix
        there (ops/fbank.fbank_batch, global CMVN) sliced at the chunks'
        frame boundaries, then the first, steady and final chunks and the
        drain (fused.make_scanned_runner).  Framing is by global sample
        position, so the frame count after c samples is num_frames(c)
        however they were chunked, and the slices are the frames that
        chunked extraction gives; a shorter example's zero-padded tail
        gives rows that the final chunk's n_valid masks.  Token for token
        the process_chunk_batch loop.  Returns each example's newly
        written tokens per chunk."""
        if any(fb.previous_residual.size for fb in self.fbanks):
            raise ValueError("process_session_wavs needs a fresh session")
        if len(wavs) != self.batch:
            raise ValueError(f"{len(wavs)} wavs for a batch of {self.batch}")
        n_first, n_steady, n_chunks, sched = _session_schedule(
            self.agent.cfg, wavs)
        if n_chunks < 2:
            out = self.process_chunk_batch([np.asarray(w) for w in wavs],
                                           finished=True)
            return [[toks] for toks in out]
        # frames emitted by each chunk boundary: the first n_chunks - 1
        # boundaries are every example's; only the final chunk differs
        fcum = [num_frames(n_first + k * n_steady) for k in range(n_chunks - 1)]
        c0 = fcum[0]
        cs = fcum[1] - fcum[0] if n_chunks > 2 else 0
        # padded to the schedule, not the batch's longest
        mx_last = num_frames(sched) - fcum[-1]
        staged = stage_session_wavs(self.agent, wavs)
        first, mid, last = featurize(staged.wav_mat, self.agent.global_cmvn,
                                     c0, cs, n_chunks - 2, mx_last)
        runner = fused_steps.make_scanned_runner(self.step_fn)
        n_before = self.state.n_tokens.cpu().numpy()
        self.state, counts = runner(self.state, first, mid, last,
                                    staged.n_valid)
        return self._unpack_counts(n_before, counts, n_chunks)


# ---------------------------------------------------------------------------
# MMA / wait-k agent
# ---------------------------------------------------------------------------

class MMASession(StreamingSession):
    def __init__(self, agent):
        super().__init__(agent)
        self.dec_state = mma_mod.mma_decoder_init_state(
            agent.cfg, 1, agent.acfg.max_tgt_len, device=agent.device)
        self._attempt = None

    @torch.no_grad()
    def policy(self) -> int:
        if not self._got_first:
            return READ
        dev = self.agent.device
        prev = torch.tensor([self.target_ids[-1] if self.target_ids
                             else EOS], device=dev)
        logits, action, new_state = mma_mod.mma_decoder_step(
            self.agent.model.decoder, self.agent.cfg, self.dec_state, prev,
            self.enc_buf, torch.tensor([self.src_len], device=dev),
            not self.finished_read)
        if int(action[0]) == 0:
            # READ: keep the advanced monotonic positions, roll back the KV
            # caches and the step
            self.dec_state = mma_mod.adopt_on_read(self.dec_state, new_state)
            self._attempt = None
            return READ
        self._attempt = (logits, new_state)
        return WRITE

    def predict(self) -> Optional[int]:
        logits, new_state = self._attempt
        idx = int(logits[0].argmax())
        if (self.agent.acfg.force_finish and idx == EOS
                and not self.finished_read):
            self._attempt = None   # discard the attempt entirely
            return None
        self.dec_state = new_state
        self._commit(idx)
        return idx


class MMAAgent(SpeechAgent):
    session_cls = MMASession

    def __init__(self, model, vocab, acfg=None, global_cmvn=None,
                 fused: bool = False):
        super().__init__(model, vocab, acfg, global_cmvn)
        self.fused = fused
        if fused:
            self._fused_step = fused_steps.make_mma_fused_step(model,
                                                               self.cfg)

    def _fused_init(self, batch: int):
        return fused_steps.mma_fused_init(
            self.model, self.cfg, self.acfg.max_src_frames,
            self.acfg.max_tgt_len, batch=batch, device=self.device)


# ---------------------------------------------------------------------------
# CIF agent
# ---------------------------------------------------------------------------

class CIFSession(StreamingSession):
    def __init__(self, agent):
        super().__init__(agent)
        cfg, dev = agent.cfg, agent.device
        self.dec_state = cif_mod.cif_decoder_init_state(
            cfg, 1, agent.acfg.max_tgt_len, device=dev)
        self.cif_state = cif_mod.cif_layer_init_state(agent.model.cif, cfg, 1,
                                                      device=dev)
        self.cif_buf = torch.zeros(1, agent.acfg.max_tgt_len, cfg.embed_dim,
                                   dtype=cfg.dtype, device=dev)
        self.cif_len = 0

    def _consume_encoder_extra(self, out):
        feats, n_emit, self.cif_state = cif_mod.cif_layer_step(
            self.agent.model.cif, self.agent.cfg, self.cif_state,
            out.encoder_out, self.finished_read)
        n = int(n_emit[0])
        if n > 0:
            room = self.cif_buf.shape[1] - self.cif_len
            if n > room:
                self.truncated = True   # the fire buffer is full
                n = room
            if n > 0:
                self.cif_buf[:, self.cif_len:self.cif_len + n] = feats[:, :n]
                self.cif_len += n

    def policy(self) -> int:
        if not self._got_first:
            return READ
        if self.finished or self.finished_read or \
                self.cif_len > len(self.target_ids):
            return WRITE
        return READ

    @torch.no_grad()
    def predict(self) -> Optional[int]:
        dev = self.agent.device
        prev = torch.tensor([self.target_ids[-1] if self.target_ids
                             else EOS], device=dev)
        logits, new_state = cif_mod.cif_decoder_step(
            self.agent.model.decoder, self.agent.cfg, self.dec_state, prev,
            self.cif_buf, torch.tensor([self.cif_len], device=dev),
            overshoot_weight=self.agent.acfg.overshoot_weight)
        idx = int(logits[0].argmax())
        if (self.agent.acfg.force_finish and idx == EOS
                and not self.finished_read):
            return None   # discard the attempt: the old state stays
        self.dec_state = new_state
        self._commit(idx)
        return idx


class CIFAgent(SpeechAgent):
    session_cls = CIFSession

    def __init__(self, model, vocab, acfg=None, global_cmvn=None,
                 cif_beta: Optional[float] = None, fused: bool = False):
        cfg = model.cfg
        if cif_beta is not None:
            # test-time beta recalibration
            cfg = dataclasses.replace(cfg, cif_beta=cif_beta)
        super().__init__(model, vocab, acfg, global_cmvn, cfg=cfg)
        self.fused = fused
        if fused:
            self._fused_step = fused_steps.make_cif_fused_step(
                model, self.cfg, overshoot_weight=self.acfg.overshoot_weight)

    def _fused_init(self, batch: int):
        return fused_steps.cif_fused_init(self.model, self.cfg,
                                          self.acfg.max_tgt_len, batch=batch,
                                          device=self.device)


# ---------------------------------------------------------------------------
# transducer agent
# ---------------------------------------------------------------------------

class TransducerSession(StreamingSession):
    """Streaming greedy transducer: each WRITE attempt runs `decode_step`
    over the visible encoder frames (raw; pooled there when downsample >
    1) from the last emit position; all blank is a READ, and the attempt's
    label-encoder state is not adopted."""

    def __init__(self, agent):
        super().__init__(agent)
        self.dec_state = tr.init_decode_state(
            agent.cfg, 1, agent.acfg.max_tgt_len, device=agent.device)
        self._attempt = None

    @torch.no_grad()
    def policy(self) -> int:
        if not self._got_first:
            return READ
        dev, cfg = self.agent.device, self.agent.cfg
        prev = torch.tensor([self.target_ids[-1] if self.target_ids
                             else cfg.blank_idx], device=dev)
        logits, emitted, new_state = tr.decode_step(
            self.agent.model.decoder, cfg, self.dec_state, prev,
            self.enc_buf, torch.tensor([self.src_len], device=dev),
            online=not self.finished_read)
        if not bool(emitted[0]):
            self._attempt = None
            return READ
        self._attempt = (logits, new_state)
        return WRITE

    def predict(self) -> Optional[int]:
        logits, new_state = self._attempt
        idx = int(logits[0].argmax())
        if (self.agent.acfg.force_finish and idx == EOS
                and not self.finished_read):
            self._attempt = None   # discard the attempt entirely
            return None
        self.dec_state = new_state
        self._commit(idx)
        return idx


class TransducerAgent(SpeechAgent):
    session_cls = TransducerSession

    def __init__(self, model, vocab, acfg=None, global_cmvn=None,
                 fused: bool = False):
        super().__init__(model, vocab, acfg, global_cmvn)
        self.fused = fused
        if fused:
            self._fused_step = fused_steps.make_transducer_fused_step(
                model, self.cfg)

    def _fused_init(self, batch: int):
        return fused_steps.transducer_fused_init(
            self.model, self.cfg, self.acfg.max_src_frames,
            self.acfg.max_tgt_len, batch=batch, device=self.device)
