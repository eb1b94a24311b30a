"""Training CLI (counterpart of simulst_tpu/cli/train.py): the MT teacher
(--task mt --model mt_transformer --loss ce), the speech model's
joint-CTC training (--task asr|st --model s2t_emformer --loss joint_ctc),
e.g. the ASR pretraining recipe exp/1a_pretrain_asr.sh:

  python -m simulst_tpu_torch.cli.train --data DATA/en-de --task asr \\
      --model s2t_emformer --loss joint_ctc --override ctc_layer=true \\
      --loss-override ctc_factor=1.0 --loss-override label_smoothing=0.1 \\
      --cmvn global --lr 1e-3 --warmup-updates 10000 --clip-norm 10 \\
      --max-tokens 40000 --update-freq 8 --save-dir checkpoints/asr

and MMA with the latency loss from that encoder (--task st --model mma
--loss mma), the recipe exp/2_mma.sh:

  python -m simulst_tpu_torch.cli.train --data DATA/en-de --task st \\
      --model mma --loss mma --cmvn global \\
      --override simul_attn_type=infinite_lookback_fixed_pre_decision \\
      --override fixed_pre_decision_ratio=8 --override mass_preservation=true \\
      --loss-override latency_avg_weight=0.1 \\
      --loss-override latency_avg_type=differentiable_average_lagging \\
      --load-pretrained-encoder-from checkpoints/asr/checkpoint_last \\
      --lr 5e-4 --warmup-updates 4000 --clip-norm 10 --max-tokens 40000 \\
      --update-freq 4 --patience 25 --save-dir checkpoints/mma

CIF from the same encoder (--task st --model cif --loss cif), the
recipe exp/3_cif.sh:

  python -m simulst_tpu_torch.cli.train --data DATA/en-de --task st \\
      --model cif --loss cif --cmvn global --override cif_beta=1.0 \\
      --override ctc_layer=true --loss-override ctc_factor=0.3 \\
      --loss-override quant_factor=1.0 --loss-override quant_type=align \\
      --load-pretrained-encoder-from checkpoints/asr/checkpoint_last \\
      --lr 5e-4 --warmup-updates 4000 --clip-norm 10 --max-tokens 40000 \\
      --update-freq 4 --patience 25 --save-dir checkpoints/cif

and the Transformer-Transducer with the RNN-T loss from that encoder
(--task asr|st --model transducer --loss rnnt), the recipe
exp/6_transducer.sh:

  python -m simulst_tpu_torch.cli.train --data DATA/en-de --task st \\
      --model transducer --loss rnnt --cmvn global \\
      --loss-override fastemit_lambda=0.01 \\
      --loss-override offline_factor=1.0 \\
      --load-pretrained-encoder-from checkpoints/asr/checkpoint_last \\
      --lr 5e-4 --warmup-updates 4000 --clip-norm 10 --max-tokens 20000 \\
      --update-freq 8 --patience 25 --save-dir checkpoints/transducer

The manifests are <data>/{train,dev}_st.tsv (speech: id, audio, n_frames,
src_text, tgt_text; text: src_text and tgt_text), the dictionary
<data>/spm_*.txt (or --vocab), global CMVN stats <data>/gcmvn.npz.  asr
trains on src_text, st on tgt_text; SpecAugment (policy "lb") masks the
training batches, never the validation ones.  --load-params and
--load-pretrained-{encoder,decoder}-from initialise the parameters, or one
component of them, from a checkpoint of this package (checkpoint_last, a
best or averaged checkpoint, or checkpoint_resume): a component takes
exactly the keys the model has, so an ASR encoder's CTC head is left
behind.  --pack (s2t_emformer + joint_ctc only) trains the Emformer stack
over sequence-packed rows (train/packing.py): each training batch gets a
pack plan, whose row length is fixed per frame bucket by that bucket's
first batch; validation stays unpacked.  --eval-metric bleu|wer adds the
inline decode's corpus BLEU or WER to each validation (greedy, or beam
--eval-beam, up to --eval-max-len tokens, through cli/generate's
decode_batch), and the best checkpoints follow --best-metric (by default
that metric; BLEU kept by maximum, loss and WER by minimum); as in the
JAX package, --task mt never decodes, so with --eval-metric bleu it
writes no best checkpoint and never counts patience.  --mtl (--task st)
trains the CE on the translations and the joint loss's CTC on the
transcripts (each batch's `src_target`); --encoder-freezing-updates N
zeroes the encoder's gradients for the first N updates; --tensorboard
logs the scalars to <save-dir>/tb, --wandb-project to wandb (skipped
where the package is missing); --profile DIR writes a torch.profiler
trace of one update after two warm-up updates.  The JAX package's
--rng-impl picks JAX's PRNG and has no counterpart here: dropout draws
Philox masks from seeds of a torch.Generator.

The offline S2T transformer with the non-causal conv-pos,
s2t_transformer_convpos (the ASR model before the Emformer), trains with
--task asr|st --loss joint_ctc, the CE alone (it has no CTC head).  The
model trains on the card unless --device names another.  MMA and CIF
also train on --task asr (the transcripts) and under --loss joint_ctc
(their decoder's CE with the encoder's CTC), as the JAX package's
build_loss pairs them.  Any other task, model or loss raises
NotImplementedError: the JAX package's cli/train does not train those
either.

Data parallelism on N cards of one node (the reference's fairseq DDP):

  torchrun --standalone --nproc-per-node N -m simulst_tpu_torch.cli.train ...

Every rank reads its node's manifest shard (make_batches shards by
torchrun's node, as the JAX package shards by process) and trains on its
rows of each batch; the gradients and metrics are summed over the ranks
and divided by the global sample size (train/state.py), the validation
loss and the inline BLEU / WER statistics are summed over the ranks, and
only rank 0 writes checkpoints, logs, tensorboard and wandb.  Each rank
runs on its own card over NCCL; --device cpu runs the ranks on the CPU
over gloo.  --pack with more than one rank raises, as the JAX CLI
asserts.  Without torchrun's environment nothing of this applies.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os

import numpy as np
import torch

from simulst_tpu_torch import comm
from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.cli.generate import decode_batch
from simulst_tpu_torch.data.dataset import (BatcherConfig, SpeechDataset,
                                            make_batches)
from simulst_tpu_torch.data.manifest import filter_by_frames, load_tsv
from simulst_tpu_torch.data.text_dataset import TextDataset, make_text_batches
from simulst_tpu_torch.data.vocab import EOS, PAD, Vocabulary
from simulst_tpu_torch.decode.beam import BeamConfig
from simulst_tpu_torch.decode.scoring import score_stats, scores_from_stats
from simulst_tpu_torch.losses.cif_loss import CIFLossConfig, cif_loss
from simulst_tpu_torch.losses.joint_ctc import JointCTCConfig, joint_ctc_loss
from simulst_tpu_torch.losses.label_smoothed_ce import ce_loss
from simulst_tpu_torch.losses.mma_loss import MMALossConfig, mma_loss
from simulst_tpu_torch.losses.rnnt_loss import RNNTLossConfig, rnnt_criterion
from simulst_tpu_torch.models.cif import CIFConfig, CIFModel
from simulst_tpu_torch.models.mma import MMAConfig, MMAModel
from simulst_tpu_torch.models.mt_transformer import MTConfig, MTTransformerModel
from simulst_tpu_torch.models.s2t_convpos import (S2TConvPosConfig,
                                                  S2TConvPosModel)
from simulst_tpu_torch.models.s2t_emformer import (S2TEmformerConfig,
                                                   S2TEmformerModel)
from simulst_tpu_torch.models.transducer import (TransducerConfig,
                                                 TransducerModel)
from simulst_tpu_torch.nn.conv import subsampler_out_lengths
from simulst_tpu_torch.ops.specaugment import spec_augment
from simulst_tpu_torch.train.checkpoint import (conform_state,
                                                load_checkpoint,
                                                load_pretrained_component,
                                                save_checkpoint)
from simulst_tpu_torch.train import mesh as mesh_lib
from simulst_tpu_torch.train import packing
from simulst_tpu_torch.train.loop import LoopConfig, Trainer
from simulst_tpu_torch.train.optim import OptimConfig

# (task, model, loss) combinations the port trains: every one the JAX
# package's cli/train trains (its build_loss pairs any model with any loss,
# and the other speech pairings fail there)
PORTED = {("mt", "mt_transformer", "ce"),
          ("asr", "s2t_emformer", "joint_ctc"),
          ("st", "s2t_emformer", "joint_ctc"),
          ("asr", "mma", "mma"),
          ("st", "mma", "mma"),
          ("asr", "mma", "joint_ctc"),
          ("st", "mma", "joint_ctc"),
          ("asr", "cif", "cif"),
          ("st", "cif", "cif"),
          ("asr", "cif", "joint_ctc"),
          ("st", "cif", "joint_ctc"),
          ("asr", "transducer", "rnnt"),
          ("st", "transducer", "rnnt"),
          ("asr", "s2t_transformer_convpos", "joint_ctc"),
          ("st", "s2t_transformer_convpos", "joint_ctc")}
MODELS = {"mt_transformer": (MTConfig, MTTransformerModel),
          "s2t_emformer": (S2TEmformerConfig, S2TEmformerModel),
          "mma": (MMAConfig, MMAModel),
          "cif": (CIFConfig, CIFModel),
          "transducer": (TransducerConfig, TransducerModel),
          "s2t_transformer_convpos": (S2TConvPosConfig, S2TConvPosModel)}
LABEL_SMOOTHING = 0.1


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", help="dir with {split}_st.tsv + vocab")
    p.add_argument("--train-split", default="train")
    p.add_argument("--valid-split", default="dev")
    p.add_argument("--vocab", default=None, help="vocab .txt/.model path")
    p.add_argument("--model", default="s2t_emformer")
    p.add_argument("--task", default="st", choices=["asr", "st", "mt"])
    p.add_argument("--loss", default="joint_ctc",
                   choices=["joint_ctc", "mma", "cif", "rnnt", "ce"])
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--max-updates", type=int, default=100000)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--update-freq", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-updates", type=int, default=4000)
    p.add_argument("--clip-norm", type=float, default=10.0)
    p.add_argument("--patience", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=100,
                   help="updates between train_log.jsonl records "
                        "(fairseq's option)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--cmvn", default="utterance",
                   choices=["utterance", "global", "none"],
                   help="feature normalization; 'global' reads gcmvn.npz "
                        "from the data dir")
    p.add_argument("--specaugment", action="store_true", default=True)
    p.add_argument("--no-specaugment", dest="specaugment",
                   action="store_false")
    p.add_argument("--resume", default=None,
                   help="checkpoint_resume path (params + optimizer + step)")
    p.add_argument("--load-params", default=None,
                   help="checkpoint to initialise every parameter from")
    p.add_argument("--load-pretrained-encoder-from", default=None,
                   help="checkpoint to initialise the encoder from")
    p.add_argument("--load-pretrained-decoder-from", default=None,
                   help="checkpoint to initialise the decoder from")
    p.add_argument("--override", action="append", default=[],
                   help="model config overrides key=value")
    p.add_argument("--loss-override", action="append", default=[],
                   help="loss config overrides key=value")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    p.add_argument("--pack", action="store_true",
                   help="sequence packing: run the Emformer stack over "
                        "segment-packed rows (train/packing.py); "
                        "s2t_emformer + joint_ctc")
    p.add_argument("--eval-metric", default="none",
                   choices=["none", "bleu", "wer"],
                   help="inline validation metric (the reference's "
                        "inference config)")
    p.add_argument("--eval-beam", type=int, default=1)
    p.add_argument("--eval-max-len", type=int, default=96)
    p.add_argument("--best-metric", default=None,
                   help="metric for best-checkpoint selection (default: "
                        "the eval metric if set, else loss)")
    p.add_argument("--mtl", action="store_true",
                   help="multi-task: CE on translations + CTC on "
                        "transcripts (--task st)")
    p.add_argument("--encoder-freezing-updates", type=int, default=0,
                   help="zero the encoder's gradients for the first N "
                        "updates")
    p.add_argument("--tensorboard", action="store_true",
                   help="also log scalars to <save-dir>/tb")
    p.add_argument("--wandb-project", default=None,
                   help="wandb project (skipped if wandb is not installed)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one update after "
                        "warm-up to DIR/trace.json")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = parser().parse_args(argv)
    path = (args.task, args.model, args.loss)
    if path not in PORTED:
        raise NotImplementedError(
            f"--task {args.task} --model {args.model} --loss {args.loss} is "
            "not trained by the JAX package either: its cli/train fails on "
            "it (on the speech tasks KeyError 'attn_list' under the mma "
            "loss, no cif_beta under the cif loss, an unpacking error under "
            "rnnt, a shape error for the transducer under joint_ctc or mma; "
            "ROADMAP.md lists them); the port trains "
            + ", ".join(f"--task {t} --model {m} --loss {l}"
                        for t, m, l in sorted(PORTED)))
    if args.pack and (args.model, args.loss) != ("s2t_emformer",
                                                 "joint_ctc"):
        raise ValueError("--pack trains --model s2t_emformer --loss "
                         "joint_ctc only, as the JAX package's")
    args.overrides = dict(cfglib.parse_override(s) for s in args.override)
    args.loss_overrides = dict(cfglib.parse_override(s)
                               for s in args.loss_override)
    return args


def checkpoint_params(state):
    """The parameters of a restored checkpoint: its state_dict, or a
    resumable checkpoint's params."""
    return state["params"] if "params" in state else state


def _checkpoint_params(path: str):
    return checkpoint_params(load_checkpoint(path)[0])


def build_model(args, vocab_size: int, device=None, params=None):
    """The model's default config (transformer_small, s2t_emformer_s, or
    MMA, CIF or the transducer on s2t_emformer_s) with --override applied;
    weights from a generator seeded with --seed, then from `params` (a
    restored checkpoint's) or --load-params and the
    --load-pretrained-*-from components."""
    config_cls, model_cls = MODELS[args.model]
    cfg = cfglib.apply_overrides(config_cls(vocab_size=vocab_size),
                                 args.overrides)
    model = model_cls(cfg, generator=torch.Generator().manual_seed(args.seed),
                      device=device)
    if params is None and args.load_params:
        params = _checkpoint_params(args.load_params)
    if params is not None:
        model.load_state_dict(conform_state(model.state_dict(), params))
    for comp, path in (("encoder", args.load_pretrained_encoder_from),
                       ("decoder", args.load_pretrained_decoder_from)):
        if path:
            pre = _checkpoint_params(path)
            model.load_state_dict(load_pretrained_component(
                model.state_dict(), {k[len(comp) + 1:]: v
                                     for k, v in pre.items()
                                     if k.startswith(comp + ".")}, comp))
            print(f"loaded pretrained {comp} from {path}")
    return model


def build_loss(args, model):
    """loss_fn(model, batch, rngs) -> (summed loss, metrics); no dropout
    and no SpecAugment when rngs is None (validation)."""
    if args.loss == "ce":
        def fn(model, batch, rngs):
            logits, _ = model(batch["src_tokens"], batch["prev_tokens"],
                              rngs=rngs)
            loss, nll = ce_loss(logits, batch["target"], LABEL_SMOOTHING, PAD)
            ntokens = (batch["target"] != PAD).sum()
            return loss, {"loss": loss.detach(), "nll_loss": nll.detach(),
                          "ntokens": ntokens,
                          "nsentences": batch["target"].shape[0],
                          "sample_size": ntokens}
        return fn

    specaugment = args.specaugment
    if args.loss == "mma":
        lcfg = cfglib.apply_overrides(MMALossConfig(), args.loss_overrides)

        def criterion(logits, extra, batch):
            return mma_loss(logits, extra, batch["target"],
                            batch["feat_lengths"], lcfg)
    elif args.loss == "cif":
        lcfg = cfglib.apply_overrides(
            CIFLossConfig(cif_beta=model.cfg.cif_beta), args.loss_overrides)

        def criterion(logits, extra, batch):
            return cif_loss(logits, extra, batch["target"],
                            batch["feat_lengths"], lcfg)
    elif args.loss == "rnnt":
        lcfg = cfglib.apply_overrides(RNNTLossConfig(), args.loss_overrides)

        def criterion(logits, extra, batch):
            return rnnt_criterion(logits, extra, lcfg)
    else:
        lcfg = cfglib.apply_overrides(JointCTCConfig(), args.loss_overrides)

        def criterion(logits, extra, batch):
            # --mtl batches carry the transcripts for the CTC
            return joint_ctc_loss(logits, extra, batch["target"], lcfg,
                                  ctc_target=batch.get("src_target"))

    def fn(model, batch, rngs):
        feats = batch["feats"]
        if specaugment and rngs is not None:
            feats = spec_augment(rngs.generator, feats, batch["feat_lengths"])
        # a batch that carries a pack plan (attach_pack_plan) trains packed
        packed = {} if "pack_frame_gather" not in batch else {
            "pack_plan": packing.PackPlan(*(batch[f"pack_{f}"] for f in
                                            packing.PackPlan._fields))}
        logits, extra = model(feats, batch["feat_lengths"],
                              batch["prev_tokens"], rngs=rngs, **packed)
        return criterion(logits, extra, batch)
    return fn


def attach_pack_plan(batch, model, n_p_by_bucket):
    """Add this batch's pack plan (train/packing.py) to it as pack_* int32
    arrays: the post-subsample lengths' segments first-fit-decreasing into
    rows of n_p segments, the row count rounded up to a multiple of 4.  n_p
    is fixed per frame bucket by its first batch (`n_p_by_bucket`, kept by
    the caller), among the row lengths from the bucket's to 4x it that keep
    the grouped attention."""
    cfg, ecfg = model.cfg, model.cfg.emformer
    l4 = subsampler_out_lengths(
        model.encoder.subsample,
        torch.as_tensor(batch["feat_lengths"]).cpu()).numpy()
    U4 = batch["feats"].shape[1] // cfg.stride
    n0 = U4 // ecfg.segment
    n_p = n_p_by_bucket.get(U4)
    if n_p is None:
        n_p = n_p_by_bucket[U4] = packing.choose_row_segments(
            l4, ecfg.segment, packing.usable_row_segments(ecfg, n0, 4 * n0))
    plan = packing.pack_plan(l4, U4, ecfg.segment, ecfg.right_context,
                             row_segs=n_p)
    rows = plan.frame_gather.shape[0]
    if rows % 4:
        plan = packing.pack_plan(l4, U4, ecfg.segment, ecfg.right_context,
                                 n_rows=rows + 4 - rows % 4, row_segs=n_p)
    for f in packing.PackPlan._fields:
        batch[f"pack_{f}"] = getattr(plan, f)
    return batch


def optim_config(args) -> OptimConfig:
    return OptimConfig(lr=args.lr, warmup_updates=args.warmup_updates,
                       clip_norm=args.clip_norm)


def build_valid_fn(args, vocab, loss_fn, batches_fn, device, mesh=None):
    """Validation loss per sample_size unit, no dropout; with --eval-metric
    also the corpus BLEU or WER of the inline decode (greedy or beam
    --eval-beam through cli/generate's decode_batch), except for --task mt,
    which validates on the loss alone, as the JAX package's does.  With a
    data-parallel `mesh` each rank validates its rows of every batch and
    the loss sums and the score's statistics are summed over the ranks."""
    decode = args.eval_metric != "none" and args.task != "mt"
    beam_cfg = BeamConfig(beam_size=args.eval_beam,
                          max_len=args.eval_max_len)
    parallel = mesh is not None and mesh.size("data") > 1

    def valid_fn(model):
        total, n = 0.0, 0.0
        refs, hyps = [], []
        for batch in batches_fn():
            ids = batch.pop("ids", None)
            batch.pop("indices", None)
            if parallel:
                batch = mesh_lib.shard_batch(mesh, batch)
            n_real = batch.pop("n_real", None)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            _, metrics = loss_fn(model, batch, None)
            total += float(metrics["loss"])
            n += float(metrics["sample_size"])
            if not decode or ids is None:
                continue
            tokens, lengths = decode_batch(model, batch, beam_cfg)
            tokens, lengths = tokens.cpu().numpy(), lengths.cpu().numpy()
            target = batch["target"].cpu().numpy()
            for j in range(tokens.shape[0] if n_real is None else n_real):
                hyps.append(vocab.decode_ids(
                    [int(t) for t in tokens[j][:int(lengths[j])]
                     if t != EOS]))
                refs.append(vocab.decode_ids(
                    [int(t) for t in target[j] if t not in (PAD, EOS)]))
        sums = torch.tensor([total, n], dtype=torch.float64)
        stats = score_stats(refs, hyps) if decode else None
        if parallel:
            comm.all_reduce_(mesh, sums, ["data"])
            if stats is not None:
                stats = comm.all_reduce_(mesh, stats, ["data"])
        out = {"loss": float(sums[0]) / max(float(sums[1]), 1.0)}
        if stats is not None and float(stats[-1]) > 0:
            out[args.eval_metric] = scores_from_stats(stats)[
                args.eval_metric]
        return out
    return valid_fn


def _find_vocab(args) -> Vocabulary:
    path = args.vocab
    if path is None:
        for cand in sorted(os.listdir(args.data)):
            if cand.startswith("spm_") and cand.endswith(".txt"):
                path = os.path.join(args.data, cand)
                break
    if path is None:
        raise FileNotFoundError(f"no spm_*.txt dictionary in {args.data}; "
                                "pass --vocab")
    return (Vocabulary.from_spm(path) if path.endswith(".model")
            else Vocabulary.from_txt(path))


def _datasets(args, vocab, bcfg):
    """(train batches by epoch, valid batches) for the task."""
    def rows(split):
        return load_tsv(os.path.join(args.data, f"{split}_st.tsv"))

    valid_cfg = dataclasses.replace(bcfg, shuffle=False)
    if args.task == "mt":
        train_ds = TextDataset(rows(args.train_split), vocab)
        valid_ds = TextDataset(rows(args.valid_split), vocab)
        return (lambda epoch: make_text_batches(train_ds, bcfg, epoch),
                lambda: make_text_batches(valid_ds, valid_cfg))
    stats = None
    if args.cmvn == "global":
        with np.load(os.path.join(args.data, "gcmvn.npz")) as f:
            stats = {"mean": f["mean"], "std": f["std"]}
    field = "src_text" if args.task == "asr" else "tgt_text"
    mtl = args.mtl and args.task == "st"
    train_ds = SpeechDataset(filter_by_frames(rows(args.train_split)), vocab,
                             bcfg, field, global_stats=stats, mtl_src=mtl)
    valid_ds = SpeechDataset(rows(args.valid_split), vocab, valid_cfg, field,
                             global_stats=stats, mtl_src=mtl)
    # one manifest shard per node; the node's ranks split its batches' rows
    nodes, node = comm.node_shards()
    return (lambda epoch: make_batches(train_ds, epoch=epoch,
                                       num_shards=nodes, shard_id=node),
            lambda: make_batches(valid_ds, num_shards=nodes, shard_id=node))


def main(argv=None):
    args = parse_args(argv)
    if not args.data:
        raise SystemExit("--data is required")
    mesh, device = None, args.device
    if comm.init_from_environment(args.device) is not None:
        mesh = comm.make_mesh()
        device = mesh.device
        print(f"data-parallel: rank {mesh.rank} of {mesh.world} on "
              f"{device} over {mesh.backend}", flush=True)
        if args.pack and mesh.size("data") > 1:
            raise ValueError("--pack with data parallelism needs per-rank "
                             "pack plans, which the JAX CLI refuses too")
    vocab = _find_vocab(args)
    bcfg = BatcherConfig(max_tokens=args.max_tokens, seed=args.seed,
                         cmvn=args.cmvn)
    if mesh is not None:
        # every batch splits evenly over the node's data ranks
        nodes, _ = comm.node_shards()
        bcfg = dataclasses.replace(bcfg, batch_multiple=math.lcm(
            bcfg.batch_multiple, max(mesh.size("data") // nodes, 1)))
    train_batches, valid_batches = _datasets(args, vocab, bcfg)

    model = build_model(args, len(vocab), device=device)
    device = next(model.parameters()).device
    if mesh is not None:
        comm.replicate(mesh, model)
    loss_fn = build_loss(args, model)
    if args.pack:
        unpacked, n_p_by_bucket = train_batches, {}

        def train_batches(epoch):
            for batch in unpacked(epoch):
                yield attach_pack_plan(batch, model, n_p_by_bucket)

    best_metric = args.best_metric or (
        args.eval_metric if args.eval_metric != "none" else "loss")
    loop_cfg = LoopConfig(max_updates=args.max_updates, patience=args.patience,
                          log_interval=args.log_interval,
                          save_dir=args.save_dir, seed=args.seed,
                          best_metric=best_metric,
                          maximize_metric=best_metric == "bleu",
                          tensorboard=args.tensorboard,
                          wandb_project=args.wandb_project,
                          profile_dir=args.profile)
    metadata = {"model": args.model, "config": cfglib.to_dict(model.cfg)}
    if args.task != "mt":
        metadata["cmvn"] = args.cmvn
    trainer = Trainer(loss_fn, optim_config(args), loop_cfg, model,
                      valid_fn=build_valid_fn(args, vocab, loss_fn,
                                              valid_batches, device, mesh),
                      freeze_until=({"encoder": args.encoder_freezing_updates}
                                    if args.encoder_freezing_updates > 0
                                    else None),
                      update_freq=args.update_freq, metadata=metadata,
                      device=device, mesh=mesh)
    if args.resume:
        print(f"resumed from {args.resume} at update "
              f"{trainer.resume(args.resume)}")

    state = trainer.fit(train_batches)
    if comm.is_main():
        save_checkpoint(os.path.join(args.save_dir, "checkpoint_last"),
                        state.model.state_dict(),
                        metadata={**metadata, "step": state.step})
    comm.shutdown(mesh)
    return state


if __name__ == "__main__":
    main()
