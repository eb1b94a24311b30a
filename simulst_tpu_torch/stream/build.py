"""Checkpoint -> model -> streaming agent (counterpart of
simulst_tpu/stream/build.py), for cli/stream_eval.py.

The model's config is the one stamped in the checkpoint's metadata (by
cli/train), with `overrides` on top and the vocabulary's size; its
parameters are the checkpoint's, conformed to the model
(train/checkpoint.conform_state: an ASR encoder's CTC head under an MMA
model is left behind, a missing parameter raises).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.cli.train import MODELS
from simulst_tpu_torch.data.vocab import Vocabulary
from simulst_tpu_torch.stream.agents import (AgentConfig, CIFAgent, MMAAgent,
                                             SpeechAgent, TransducerAgent)
from simulst_tpu_torch.train.checkpoint import conform_state, load_checkpoint

# the models an agent of the port streams
STREAMED = ("mma", "cif", "transducer")
AGENTS = ("mma", "waitk", "cif", "transducer")


def load_vocab(path: str) -> Vocabulary:
    return (Vocabulary.from_spm(path) if path.endswith(".model")
            else Vocabulary.from_txt(path))


def auto_buffer_sizes(cfg, max_samples: int, sample_rate: int = 16000):
    """(max_src_frames, max_tgt_len) that fit max_samples of audio with one
    segment of slack, the frames rounded up to 128 (at least 1024), the
    tokens one per two frames in [256, 2048] in steps of 64."""
    n_fbank = max_samples // (sample_rate // 100) + 2   # 10 ms shift
    frames = (-(-n_fbank // cfg.stride)
              + cfg.segment_length // cfg.stride + 8)
    frames = max(1024, -(-frames // 128) * 128)
    tgt = max(256, min(2048, -(-(frames // 2) // 64) * 64))
    return frames, tgt


def build_agent(checkpoint: str, vocab: Vocabulary, agent_type: str = "mma",
                model_name: Optional[str] = None, overrides=None,
                waitk: Optional[int] = None, cif_beta: Optional[float] = None,
                overshoot_weight: float = 1.0,
                global_cmvn_path: Optional[str] = None, fused: bool = False,
                max_src_frames: Optional[int] = None,
                max_tgt_len: Optional[int] = None, warn=print,
                device=None) -> SpeechAgent:
    """Restore a checkpoint of cli/train and wire the agent: "mma" and
    "waitk" (waitk: the test-time lagging), "cif" (cif_beta: the test-time
    beta) or "transducer".  Without a model name in the checkpoint's
    metadata, the cif and transducer agents take their own model, the
    others MMA.  The model runs on `device`, the card unless the caller
    names another."""
    if agent_type not in AGENTS:
        raise ValueError(f"unknown agent {agent_type!r}; the agents are "
                         + ", ".join(AGENTS))
    state, meta = load_checkpoint(checkpoint)
    meta = meta or {}
    params = state["params"] if "params" in state else state
    name = model_name or meta.get("model") or {
        "cif": "cif", "transducer": "transducer"}.get(agent_type, "mma")
    if name not in STREAMED:
        raise NotImplementedError(f"streaming a {name!r} model is not yet "
                                  "ported; the port streams "
                                  + ", ".join(STREAMED))
    config_cls, model_cls = MODELS[name]
    overrides = dict(overrides or {})
    if waitk is not None:
        overrides["waitk_testtime"] = waitk
    cfg = cfglib.from_dict(config_cls, {**(meta.get("config") or {}),
                                        **overrides,
                                        "vocab_size": len(vocab)})
    model = model_cls(cfg, device=device)
    model.load_state_dict(conform_state(model.state_dict(), params))
    model.eval()

    gcmvn = None
    if global_cmvn_path:
        with np.load(global_cmvn_path) as stats:
            gcmvn = (stats["mean"], stats["std"])
    trained_cmvn = meta.get("cmvn")
    if trained_cmvn == "global" and gcmvn is None:
        warn("WARNING: checkpoint was trained with GLOBAL CMVN but no "
             "global-cmvn stats were given: the agent will feed "
             "un-normalized features and quality will collapse.")
    elif trained_cmvn == "utterance":
        warn("WARNING: checkpoint was trained with UTTERANCE CMVN, which a "
             "streaming agent cannot reproduce (the future is unknown). "
             "Retrain with --cmvn global and pass global CMVN stats here.")

    sizes = {}
    if max_src_frames is not None:
        sizes["max_src_frames"] = max_src_frames
    if max_tgt_len is not None:
        sizes["max_tgt_len"] = max_tgt_len
    acfg = AgentConfig(overshoot_weight=overshoot_weight, **sizes)
    if agent_type in ("mma", "waitk"):
        return MMAAgent(model, vocab, acfg, global_cmvn=gcmvn, fused=fused)
    if agent_type == "transducer":
        return TransducerAgent(model, vocab, acfg, global_cmvn=gcmvn,
                               fused=fused)
    return CIFAgent(model, vocab, acfg, global_cmvn=gcmvn, cif_beta=cif_beta,
                    fused=fused)
