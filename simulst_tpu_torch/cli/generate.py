"""Offline batch decoding (counterpart of simulst_tpu/cli/generate.py).

`decode_batch` encodes a whole batch once, repeats the encoder output per
beam, and runs `beam_search` (or `greedy_decode` at beam 1) over the
model's incremental decoder step: `decoder_step` for s2t_emformer and
s2t_transformer_convpos,
`mma_decoder_step` offline (wait-k clipped to the source's end, READ
ignored) for MMA, `cif_decoder_step` over the fired CIF features for CIF,
and for the transducer the offline `decode_step` (the emit at the source's
last frame forced), seeded with the blank, each hypothesis with its own
emit cursor (`_build_transducer`).  `decode_batch_mt` decodes the MT
teacher's text, and `decode_batch_ensemble` averages N checkpoints'
per-step probabilities (fairseq's EnsembleModel; not the transducer's).
`main` is fairseq-generate: S-/T-/D- lines, parsed by data/kd.py for
distillation, and a corpus BLEU or WER line:

  python -m simulst_tpu_torch.cli.generate --data DATA/en-de \\
      --gen-subset tst-COMMON --checkpoint SAVE/checkpoint_avg \\
      --vocab DATA/en-de/spm_unigram8000.txt --beam 5 --scoring bleu

A colon-separated --checkpoint decodes an ensemble.  The model is built
from each checkpoint's metadata (cli/train's MODELS) and runs on the card
unless --device names another.  exp/6_transducer.sh decodes its
transducer with --model transducer --beam 1.

Under torchrun (`torchrun --standalone --nproc-per-node N -m
simulst_tpu_torch.cli.generate ...`) rank r of N decodes shard r of the
subset (every N-th utterance of the length order, the reference's
distributed generate), the BLEU / WER sufficient statistics are summed
over the ranks (decode/scoring.score_stats), and rank 0 writes every
rank's lines, by utterance, and the corpus score.
"""
from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from simulst_tpu_torch import comm
from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.data.dataset import (BatcherConfig, SpeechDataset,
                                            make_batches)
from simulst_tpu_torch.data.manifest import load_tsv
from simulst_tpu_torch.data.text_dataset import TextDataset, make_text_batches
from simulst_tpu_torch.data.vocab import EOS, Vocabulary
from simulst_tpu_torch.decode.beam import BeamConfig, beam_search, greedy_decode
from simulst_tpu_torch.decode.scoring import score_stats, scores_from_stats
from simulst_tpu_torch.models import cif as cif_mod
from simulst_tpu_torch.models import mma as mma_mod
from simulst_tpu_torch.models import s2t_convpos as convpos
from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.models import transducer as tr
from simulst_tpu_torch.models.mt_transformer import (MTTransformerModel,
                                                     text_encoder_forward)
from simulst_tpu_torch.nn import attention as attn_mod
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.core import lengths_to_mask
from simulst_tpu_torch.train.checkpoint import load_checkpoint


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _run_search(step_fn, dstate, reorder_fn, bos, b, beam_cfg: BeamConfig,
                device, prefix_tokens=None):
    if prefix_tokens is not None:
        prefix_tokens = torch.as_tensor(prefix_tokens, device=device)
    if beam_cfg.beam_size == 1:
        return greedy_decode(step_fn, dstate, b, beam_cfg,
                             prefix_tokens=prefix_tokens, device=device,
                             bos=bos)
    res = beam_search(step_fn, dstate, b, beam_cfg, reorder_fn,
                      prefix_tokens=prefix_tokens, device=device, bos=bos)
    return res.tokens[:, 0], res.lengths[:, 0]


def _reorder_caches(caches, idx):
    return tuple(attn_mod.KVCache(k=c.k[idx], v=c.v[idx],
                                  length=c.length[idx]) for c in caches)


def _encode(model, batch):
    """The speech encoder over the whole batch (no dropout)."""
    device = _device(model)
    forward = (convpos.encoder_forward
               if isinstance(model, convpos.S2TConvPosModel)
               else s2t.encoder_forward)
    return forward(model.encoder, model.cfg,
                   torch.as_tensor(batch["feats"], device=device),
                   torch.as_tensor(batch["feat_lengths"], device=device))


def _build_std(model, batch, beam_cfg: BeamConfig):
    """(step_fn, decoder state, reorder_fn, seed) for one batch: the
    encoder runs once, its output repeated per beam; the search is seeded
    with EOS (seed None), the fairseq convention."""
    cfg = model.cfg
    enc = _encode(model, batch)
    b, beam = enc.encoder_out.shape[0], beam_cfg.beam_size
    enc_out = enc.encoder_out.repeat_interleave(beam, dim=0)
    enc_valid = lengths_to_mask(enc.lengths.repeat_interleave(beam),
                                enc_out.shape[1])
    dstate = tfm.decoder_init_state(cfg.decoder, b * beam,
                                    beam_cfg.max_len + 1,
                                    device=_device(model))

    def step_fn(state, tokens):
        return tfm.decoder_step(model.decoder, cfg.decoder, state, tokens,
                                enc_out, enc_valid)

    def reorder_fn(state, idx):
        return tfm.DecoderState(caches=_reorder_caches(state.caches, idx),
                                step=state.step[idx])

    return step_fn, dstate, reorder_fn, None


def _build_cif(model: cif_mod.CIFModel, batch, beam_cfg: BeamConfig):
    """Offline CIF: fire from alpha (no teacher forcing), then greedy or
    beam search over the position-aligned CIF features (the reference's
    fairseq-generate path for cif_transformer)."""
    cfg = model.cfg
    enc = _encode(model, batch)
    valid = lengths_to_mask(enc.lengths, enc.encoder_out.shape[1])
    max_out = min(int(enc.encoder_out.shape[1] / cfg.cif_beta) + 2,
                  beam_cfg.max_len + 2)
    cif_out, _ = cif_mod.cif_layer_forward(model.cif, cfg, enc.encoder_out,
                                           valid, max_out_len=max_out)
    b, beam = enc.encoder_out.shape[0], beam_cfg.beam_size
    cif_buf = cif_out.cif_out.repeat_interleave(beam, dim=0)
    cif_len = cif_out.cif_lengths.repeat_interleave(beam, dim=0)
    dstate = cif_mod.cif_decoder_init_state(cfg, b * beam,
                                            beam_cfg.max_len + 1,
                                            device=_device(model))

    def step_fn(state, tokens):
        return cif_mod.cif_decoder_step(model.decoder, cfg, state, tokens,
                                        cif_buf, cif_len)

    def reorder_fn(state, idx):
        return cif_mod.CIFDecoderState(
            caches=_reorder_caches(state.caches, idx),
            cross_caches=_reorder_caches(state.cross_caches, idx),
            step=state.step[idx])

    return step_fn, dstate, reorder_fn, None


def _build_mma(model: mma_mod.MMAModel, batch, beam_cfg: BeamConfig):
    """Offline MMA (online=False: wait-k clipped to the source's end, no
    early READ; fairseq SequenceGenerator semantics).  The monotonic head
    positions are reordered with the beams, as the KV caches are."""
    cfg = model.cfg
    enc = _encode(model, batch)
    b, beam = enc.encoder_out.shape[0], beam_cfg.beam_size
    enc_buf = enc.encoder_out.repeat_interleave(beam, dim=0)
    src_len = enc.lengths.repeat_interleave(beam, dim=0)
    dstate = mma_mod.mma_decoder_init_state(cfg, b * beam,
                                            beam_cfg.max_len + 1,
                                            device=_device(model))

    def step_fn(state, tokens):
        logits, _, state = mma_mod.mma_decoder_step(
            model.decoder, cfg, state, tokens, enc_buf, src_len, False)
        return logits, state

    def reorder_fn(state, idx):
        return mma_mod.MMADecoderState(
            caches=_reorder_caches(state.caches, idx),
            monotonic=tuple(mma_mod.MonotonicState(
                head_step=m.head_step[idx], head_read=m.head_read[idx])
                for m in state.monotonic),
            step=state.step[idx])

    return step_fn, dstate, reorder_fn, None


def _build_transducer(model: tr.TransducerModel, batch,
                      beam_cfg: BeamConfig):
    """Offline transducer decoding: the offline `decode_step` over the raw
    encoder frames (it pools them itself when downsample > 1), the emit at
    each source's last frame forced.  Each beam hypothesis carries its own
    emit cursor, prev_emit, gathered on reorder like the KV caches.  The
    search is seeded with the blank (the reference replaces the front EOS
    by bos == blank)."""
    cfg = model.cfg
    enc = _encode(model, batch)
    b, beam = enc.encoder_out.shape[0], beam_cfg.beam_size
    src = enc.encoder_out.repeat_interleave(beam, dim=0)
    src_len = enc.lengths.repeat_interleave(beam, dim=0)
    dstate = tr.init_decode_state(cfg, b * beam, beam_cfg.max_len + 1,
                                  device=_device(model))

    def step_fn(state, tokens):
        logits, _, state = tr.decode_step(model.decoder, cfg, state, tokens,
                                          src, src_len, online=False)
        return logits, state

    def reorder_fn(state, idx):
        return tr.TransducerState(caches=_reorder_caches(state.caches, idx),
                                  prev_emit=state.prev_emit[idx],
                                  step=state.step[idx])

    return step_fn, dstate, reorder_fn, cfg.blank_idx


def _build_mt(model: MTTransformerModel, batch, beam_cfg: BeamConfig):
    """Text-to-text decoding of the MT teacher (sequence-KD generation)."""
    cfg = model.cfg
    src = torch.as_tensor(batch["src_tokens"], device=_device(model))
    enc, enc_valid = text_encoder_forward(model.encoder, cfg, src)
    b, beam = src.shape[0], beam_cfg.beam_size
    enc_out = enc.repeat_interleave(beam, dim=0)
    valid = enc_valid.repeat_interleave(beam, dim=0)
    dstate = tfm.decoder_init_state(cfg.decoder, b * beam,
                                    beam_cfg.max_len + 1,
                                    device=_device(model))

    def step_fn(state, tokens):
        return tfm.decoder_step(model.decoder, cfg.decoder, state, tokens,
                                enc_out, valid)

    def reorder_fn(state, idx):
        return tfm.DecoderState(caches=_reorder_caches(state.caches, idx),
                                step=state.step[idx])

    return step_fn, dstate, reorder_fn, None


def decode_batch_mt(model, batch, beam_cfg: BeamConfig, prefix_tokens=None):
    """batch: {"src_tokens": (B, S)}.  Returns (tokens (B, L), lengths
    (B,)), the best hypotheses."""
    return _run_search(*_build_mt(model, batch, beam_cfg),
                       len(batch["src_tokens"]), beam_cfg, _device(model),
                       prefix_tokens)


def _builder(model):
    """The (step_fn, state, reorder_fn, seed) builder of a speech model."""
    if isinstance(model, tr.TransducerModel):
        return _build_transducer
    if isinstance(model, cif_mod.CIFModel):
        return _build_cif
    if isinstance(model, mma_mod.MMAModel):
        return _build_mma
    if isinstance(model, (s2t.S2TEmformerModel, convpos.S2TConvPosModel)):
        return _build_std
    raise NotImplementedError(
        f"{type(model).__name__} is not ported yet: the port decodes "
        "s2t_emformer, s2t_transformer_convpos, MMA, CIF, the transducer and "
        "(decode_batch_mt) the MT teacher")


def decode_batch(model, batch, beam_cfg: BeamConfig, prefix_tokens=None):
    """batch: {"feats": (B, T, F), "feat_lengths": (B,)} as arrays or
    tensors; prefix_tokens (B, P), PAD-padded, forces each hypothesis's
    first tokens.  Returns (tokens (B, L), lengths (B,)), the best
    hypotheses."""
    build = _builder(model)
    return _run_search(*build(model, batch, beam_cfg), len(batch["feats"]),
                       beam_cfg, _device(model), prefix_tokens)


def build_ensemble(builders):
    """One (step_fn, state, reorder_fn, seed) from N models' builders, each
    seeded with EOS: per-step log-probs averaged in probability
    (logsumexp - log N), fairseq's EnsembleModel.  log_softmax is
    idempotent, so the search's own normalisation of the averaged log-probs
    changes nothing."""
    step_fns, states, reorder_fns, _ = zip(*builders)

    def step_fn(states, tokens):
        outs = [f(s, tokens) for f, s in zip(step_fns, states)]
        lps = torch.stack([torch.log_softmax(o[0].float(), dim=-1)
                           for o in outs])
        avg = torch.logsumexp(lps, dim=0) - float(np.log(lps.shape[0]))
        return avg, tuple(o[1] for o in outs)

    def reorder_fn(states, idx):
        return tuple(r(s, idx) for r, s in zip(reorder_fns, states))

    return step_fn, tuple(states), reorder_fn, None


def decode_batch_ensemble(models, batch, beam_cfg: BeamConfig,
                          task: str = "st"):
    """Ensemble decoding over N checkpoints sharing one vocabulary (model
    families may mix, but for the transducer, as in the JAX package)."""
    if any(isinstance(m, tr.TransducerModel) for m in models):
        raise ValueError("ensemble decoding is not defined for the "
                         "transducer's emit-scan path")
    builders = [(_build_mt if task == "mt" else _builder(model))(
        model, batch, beam_cfg) for model in models]
    b = len(batch["src_tokens"] if task == "mt" else batch["feats"])
    return _run_search(*build_ensemble(builders), b, beam_cfg,
                       _device(models[0]))


def load_model(path: str, vocab_size: int, model_name=None, overrides=None,
               device=None):
    """The model of a checkpoint of this package: its config from the
    checkpoint's metadata (model name, config) with `overrides`, built by
    cli/train's build_model and loaded with the checkpoint's parameters."""
    # imported here: cli/train imports this module for its inline decode
    from simulst_tpu_torch.cli.train import (MODELS, build_model,
                                             checkpoint_params)
    state, meta = load_checkpoint(path)
    meta = meta or {}
    name = model_name or meta.get("model", "s2t_emformer")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; the models are "
                         + ", ".join(sorted(MODELS)))
    args = SimpleNamespace(
        model=name, seed=1, load_params=None,
        load_pretrained_encoder_from=None, load_pretrained_decoder_from=None,
        overrides={**(meta.get("config") or {}), **(overrides or {}),
                   "vocab_size": vocab_size})
    return build_model(args, vocab_size, device=device,
                       params=checkpoint_params(state)).eval()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True)
    p.add_argument("--gen-subset", default="tst-COMMON")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint, or CKPT1:CKPT2:... for an ensemble")
    p.add_argument("--model", default=None, help="override model name")
    p.add_argument("--vocab", default=None)
    p.add_argument("--task", default="st", choices=["asr", "st", "mt"])
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-len", type=int, default=200)
    p.add_argument("--len-penalty", type=float, default=1.0)
    p.add_argument("--min-len", type=int, default=1,
                   help="EOS blocked until this many tokens are generated")
    p.add_argument("--unk-penalty", type=float, default=0.0)
    p.add_argument("--prefix-size", type=int, default=0,
                   help="force hypotheses to start with the first N target "
                        "tokens (fairseq --prefix-size)")
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--scoring", default="bleu", choices=["bleu", "wer"])
    p.add_argument("--output", default=None)
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    return p


def _find_vocab(data: str, path=None) -> Vocabulary:
    if path is None:
        for cand in sorted(os.listdir(data)):
            if cand.startswith("spm_") and cand.endswith(".txt"):
                path = os.path.join(data, cand)
    if path is None:
        raise FileNotFoundError(f"no spm_*.txt dictionary in {data}; pass "
                                "--vocab")
    return (Vocabulary.from_spm(path) if path.endswith(".model")
            else Vocabulary.from_txt(path))


def main(argv=None) -> float:
    args = parser().parse_args(argv)
    mesh, device = None, args.device
    if comm.init_from_environment(args.device) is not None:
        mesh = comm.make_mesh()
        device = mesh.device
    n_shards, shard = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    vocab = _find_vocab(args.data, args.vocab)
    overrides = dict(cfglib.parse_override(s) for s in args.override)
    models = [load_model(ckpt, len(vocab), args.model, overrides,
                         device=device)
              for ckpt in args.checkpoint.split(":")]

    target_field = "src_text" if args.task == "asr" else "tgt_text"
    rows = load_tsv(os.path.join(args.data, f"{args.gen_subset}_st.tsv"))
    # coarse ladders: few distinct (frame, token) shapes per pass
    bcfg = BatcherConfig(max_tokens=args.max_tokens, shuffle=False,
                         batch_multiple=1,
                         frame_buckets=(256, 512, 768, 1024, 1536, 2048,
                                        3072),
                         token_buckets=(16, 32, 48, 64, 96, 128))
    beam_cfg = BeamConfig(beam_size=args.beam, max_len=args.max_len,
                          len_penalty=args.len_penalty,
                          min_len=args.min_len, unk_penalty=args.unk_penalty)
    if args.task == "mt":
        for i, r in enumerate(rows):
            r.setdefault("id", str(i))
        mine = rows[shard::n_shards]
        batches = []
        for b in make_text_batches(TextDataset(mine, vocab), bcfg):
            b["ids"] = [mine[i]["id"] for i in b["indices"]]
            batches.append(b)
    else:
        batches = make_batches(SpeechDataset(rows, vocab, bcfg,
                                             target_field),
                               num_shards=n_shards, shard_id=shard)

    refs, hyps, lines = [], [], []
    id2row = {r["id"]: i for i, r in enumerate(rows)}
    with torch.no_grad():
        for batch in batches:
            prefix = None
            if args.prefix_size > 0 and "target" in batch:
                prefix = batch["target"][:, :args.prefix_size]
            if len(models) > 1:
                tokens, lengths = decode_batch_ensemble(models, batch,
                                                        beam_cfg, args.task)
            elif args.task == "mt":
                tokens, lengths = decode_batch_mt(models[0], batch, beam_cfg,
                                                  prefix_tokens=prefix)
            else:
                tokens, lengths = decode_batch(models[0], batch, beam_cfg,
                                               prefix_tokens=prefix)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            for j in range(batch["n_real"]):
                i = id2row[batch["ids"][j]]
                hyp = vocab.decode_ids([int(t) for t in
                                        tokens[j][:int(lengths[j])]
                                        if t != EOS])
                ref = rows[i][target_field]
                refs.append(ref)
                hyps.append(hyp)
                lines.append((i, f"S-{i}\t{rows[i].get('src_text', '')}\n"
                                 f"T-{i}\t{ref}\nD-{i}\t0.0\t{hyp}"))

    stats = score_stats(refs, hyps)
    if mesh is not None:
        comm.all_reduce_(mesh, stats, ["data"])
        every = [None] * mesh.world
        torch.distributed.all_gather_object(every, lines)
        lines = sorted(line for part in every for line in part)
    score = scores_from_stats(stats)[args.scoring]
    lines = [text for _, text in lines]
    lines.append(f"SCORE\t{args.scoring}\t{score:.2f}")
    if mesh is not None and mesh.rank != 0:
        comm.shutdown(mesh)
        return score
    text = "\n".join(lines)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text + "\n")
    else:
        print(text)
    print(f"{args.scoring}: {score:.2f}")
    comm.shutdown(mesh)
    return score


if __name__ == "__main__":
    main()
