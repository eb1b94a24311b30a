"""Training CLI (counterpart of simulst_tpu/cli/train.py), the MT-teacher
path: --task mt --model mt_transformer --loss ce.

  python -m simulst_tpu_torch.cli.train --data DATA/en-de --task mt \
      --model mt_transformer --loss ce --lr 5e-4 --warmup-updates 4000 \
      --clip-norm 10 --max-tokens 16000 --save-dir checkpoints/mt_teacher

The manifests are <data>/{train,dev}_st.tsv with src_text and tgt_text
columns, the dictionary <data>/spm_*.txt (or --vocab).  The model trains
on the card unless --device names another.  Any other task, model or loss
raises: those are not yet ported (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.data.dataset import BatcherConfig, load_tsv
from simulst_tpu_torch.data.text_dataset import TextDataset, make_text_batches
from simulst_tpu_torch.data.vocab import PAD, Vocabulary
from simulst_tpu_torch.losses.label_smoothed_ce import ce_loss
from simulst_tpu_torch.models.mt_transformer import MTConfig, MTTransformerModel
from simulst_tpu_torch.train.checkpoint import save_checkpoint
from simulst_tpu_torch.train.loop import LoopConfig, Trainer
from simulst_tpu_torch.train.optim import OptimConfig

PORTED = {"task": "mt", "model": "mt_transformer", "loss": "ce"}
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
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", default=None,
                   help="checkpoint_resume path (params + optimizer + step)")
    p.add_argument("--override", action="append", default=[],
                   help="model config overrides key=value")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = parser().parse_args(argv)
    for key, ported in PORTED.items():
        if getattr(args, key) != ported:
            raise NotImplementedError(
                f"--{key} {getattr(args, key)} is not yet ported (ROADMAP "
                f"Queue 1); the port trains --task mt --model mt_transformer "
                f"--loss ce")
    args.overrides = dict(cfglib.parse_override(s) for s in args.override)
    return args


def build_model(args, vocab_size: int, device=None) -> MTTransformerModel:
    """MTConfig (transformer_small) with --override applied; weights from a
    generator seeded with --seed."""
    cfg = cfglib.apply_overrides(MTConfig(vocab_size=vocab_size),
                                 args.overrides)
    return MTTransformerModel(cfg, generator=torch.Generator().manual_seed(
        args.seed), device=device)


def build_loss(args, model: MTTransformerModel):
    """loss_fn(model, batch, rngs) -> (summed LS-CE, metrics); no dropout
    when rngs is None (validation)."""
    del args, model

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


def optim_config(args) -> OptimConfig:
    return OptimConfig(lr=args.lr, warmup_updates=args.warmup_updates,
                       clip_norm=args.clip_norm)


def build_valid_fn(loss_fn, batches_fn, device):
    """Validation loss per target token (sample_size), no dropout."""
    def valid_fn(model):
        total, n = 0.0, 0.0
        for batch in batches_fn():
            for key in ("ids", "n_real", "indices"):
                batch.pop(key, None)
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in batch.items()}
            _, metrics = loss_fn(model, batch, None)
            total += float(metrics["loss"])
            n += float(metrics["sample_size"])
        return {"loss": total / max(n, 1.0)}
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


def main(argv=None):
    args = parse_args(argv)
    if not args.data:
        raise SystemExit("--data is required")
    vocab = _find_vocab(args)
    bcfg = BatcherConfig(max_tokens=args.max_tokens, seed=args.seed)
    train_ds = TextDataset(load_tsv(os.path.join(
        args.data, f"{args.train_split}_st.tsv")), vocab)
    valid_ds = TextDataset(load_tsv(os.path.join(
        args.data, f"{args.valid_split}_st.tsv")), vocab)

    model = build_model(args, len(vocab), device=args.device)
    device = next(model.parameters()).device
    loss_fn = build_loss(args, model)
    loop_cfg = LoopConfig(max_updates=args.max_updates, patience=args.patience,
                          save_dir=args.save_dir, seed=args.seed)
    metadata = {"model": args.model, "config": cfglib.to_dict(model.cfg)}
    trainer = Trainer(
        loss_fn, optim_config(args), loop_cfg, model,
        valid_fn=build_valid_fn(loss_fn, lambda: make_text_batches(
            valid_ds, dataclasses.replace(bcfg, shuffle=False)), device),
        update_freq=args.update_freq,
        metadata=metadata, device=device)
    if args.resume:
        print(f"resumed from {args.resume} at update "
              f"{trainer.resume(args.resume)}")

    state = trainer.fit(lambda epoch: make_text_batches(train_ds, bcfg, epoch))
    save_checkpoint(os.path.join(args.save_dir, "checkpoint_last"),
                    state.model.state_dict(),
                    metadata={**metadata, "step": state.step})
    return state


if __name__ == "__main__":
    main()
