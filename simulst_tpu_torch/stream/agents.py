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
  * with force_finish, an EOS predicted before the source is complete is
    discarded and the agent READs instead.
A fused agent (`fused=True`) runs READ and every WRITE of a chunk in one
call of stream/fused.py's step through `FusedChunkSession`.  The batched
sessions (`FusedBatchSession`) are not ported.  Every session builds its
own state: the KV caches and the Emformer memory are written in place, so
sessions cannot share one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from simulst_tpu_torch.data.vocab import EOS, Vocabulary
from simulst_tpu_torch.models import cif as cif_mod
from simulst_tpu_torch.models import mma as mma_mod
from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.ops.fbank import OnlineFbank
from simulst_tpu_torch.stream import fused as fused_steps

READ, WRITE = 0, 1
BOW_PREFIX = "▁"  # sentencepiece word-start marker


@dataclasses.dataclass
class AgentConfig:
    max_src_frames: int = 1024      # encoder buffer capacity (subsampled)
    max_tgt_len: int = 256
    force_finish: bool = True
    overshoot_weight: float = 1.0   # CIF's EOS overshoot bias


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
                                   cfg.embed_dim, device=dev)
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


def _drain_writes(state, step_fn, max_rounds: int = 64):
    """WRITEs still pending after the final chunk (each step caps its
    attempts): step again with no new features until every example is
    finished or full, or a round writes nothing."""
    for _ in range(max_rounds):
        n_tok = state.n_tokens.cpu().numpy()
        fin = state.finished.cpu().numpy()
        if (fin | (n_tok >= state.tokens.shape[1] - 1)).all():
            break
        state, n_new = step_fn(state, None, finish=True)
        if int(n_new.sum()) == 0:
            break
    return state


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
            self.state = _drain_writes(self.state, self.step_fn)
        self.next_chunk_ms = self.chunk_ms
        n_after = int(self.state.n_tokens[0])
        self.finished = bool(self.state.finished[0]) or \
            n_after >= self.state.tokens.shape[1] - 1
        return self.state.tokens[0, n_before:n_after].tolist()

    @property
    def truncated(self) -> bool:
        return bool(self.state.truncated[0])


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
                                   device=dev)
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
