"""Training loop (counterpart of simulst_tpu/train/loop.py): epoch
iteration, the train step, validation, best-loss checkpoints with the
validation loss in the file name, patience early stopping, jsonl logging.

Every record goes to <save_dir>/train_log.jsonl and stdout, and to the
sinks the config asks for: TensorBoard scalars under <save_dir>/tb
(train/events.py writes the event files, so neither TensorFlow nor the
tensorboard package is needed) and wandb, which prints "wandb
unavailable; skipping sink" where the package is missing, as in the JAX
loop.  `profile_dir` writes a torch.profiler trace (Chrome JSON) of one
update after `PROFILE_WARMUP` warm-up updates.  The best checkpoints follow `best_metric` of the
validation metrics (loss, or the inline decode's BLEU or WER), kept by
maximum where `maximize_metric`; a validation without that metric saves
nothing and counts no patience, as in the JAX loop.

Data parallelism (`mesh`, train/mesh.py): every rank reads the same
batches (its node's manifest shard) and trains on its rows of each
(`shard_batch`); train/state.py sums the gradients and metrics over the
data ranks.  Each rank's dropout generator folds in its data index.  The
validation function is expected to sum its statistics over the ranks,
so that every rank takes the same best-checkpoint and patience
decisions; only the first rank writes the log, the sinks, the profile
and the checkpoints, and the others wait for it at a barrier.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from simulst_tpu_torch import comm
from simulst_tpu_torch.nn.core import resolve_device
from simulst_tpu_torch.train import mesh as mesh_lib
from simulst_tpu_torch.train.events import EventWriter
from simulst_tpu_torch.train.checkpoint import (find_best_checkpoints,
                                                load_checkpoint,
                                                save_checkpoint)
from simulst_tpu_torch.train.optim import OptimConfig
from simulst_tpu_torch.train.state import (create_train_state,
                                           make_accum_train_step,
                                           make_train_step, sum_metrics)


@dataclasses.dataclass
class LoopConfig:
    max_updates: int = 100000
    max_epochs: int = 1000
    log_interval: int = 100
    validate_interval_updates: int = 1000
    keep_best: int = 5
    best_metric: str = "loss"     # "loss" | "wer" | "bleu"
    maximize_metric: bool = False
    patience: int = 0
    save_dir: str = "checkpoints"
    seed: int = 1
    tensorboard: bool = False
    wandb_project: Optional[str] = None
    profile_dir: Optional[str] = None


# updates before the profiled one: the first builds the kernels and fills
# the allocator's cache
PROFILE_WARMUP = 2


# criterion metrics summed per sentence (normalised by nsentences); every
# other unrecognised metric is a sample_size-normalised loss term
_PER_SENTENCE = {"blank_rate", "ctc_recall", "ctc_precision"}
_RAW = {"loss", "gnorm", "skipped", "sample_size", "ntokens", "nsentences"}


def summarize_metrics(metrics: Dict) -> Dict[str, float]:
    """A summed metrics dict -> a normalised log record: losses per
    sample_size, nll per token, per-sentence stats per sentence, plus the
    derived CTC F1."""
    m = {k: float(v) for k, v in metrics.items()}
    denom = max(m.get("sample_size", 1.0), 1.0)
    nsent = max(m.get("nsentences", 1.0), 1.0)
    out = {}
    for k, v in m.items():
        if k in _RAW:
            continue
        elif k == "nll_loss":
            out[k] = v / max(m.get("ntokens", denom), 1.0)
        elif k in _PER_SENTENCE:
            out[k] = v / nsent
        else:
            out[k] = v / denom
    r, p = out.get("ctc_recall"), out.get("ctc_precision")
    if r is not None and p is not None:
        out["ctc_f1"] = round(2 * p * r / (p + r), 3) if (p + r) > 0 else 0.0
    return out


def make_sinks(cfg: LoopConfig):
    """The metric sinks behind the jsonl log: tensorboard and / or wandb."""
    sinks = []
    if cfg.tensorboard:
        writer = EventWriter(os.path.join(cfg.save_dir, "tb"))

        def tb_sink(record):
            step = int(record.get("update", record.get("valid_update", 0)))
            writer.add_scalars({k: v for k, v in record.items()
                                if isinstance(v, (int, float))
                                and k not in ("update", "valid_update",
                                              "epoch")}, step)
        sinks.append(tb_sink)
    if cfg.wandb_project:
        try:
            import wandb
            wandb.init(project=cfg.wandb_project, dir=cfg.save_dir,
                       resume="allow")
            sinks.append(lambda record: wandb.log(record))
        except ImportError:
            print("wandb unavailable; skipping sink")
    return sinks


def profile_update(step_fn, device, out_dir: str):
    """Run step_fn() under torch.profiler (CUDA activity on the card) and
    write out_dir/trace.json.  Returns (step_fn's result, the path)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = step_fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return out, path


class Trainer:
    def __init__(self, loss_fn: Callable, optim_cfg: OptimConfig,
                 loop_cfg: LoopConfig, model: nn.Module,
                 valid_fn: Optional[Callable] = None,
                 freeze_until: Optional[Dict[str, int]] = None,
                 update_freq: int = 1, metadata: Optional[Dict] = None,
                 device=None, mesh: Optional[comm.Mesh] = None):
        """loss_fn(model, batch, rngs) -> (loss, metrics); valid_fn(model)
        -> dict of metrics, "loss" among them.  The model moves
        to `device`, the card unless the caller names another; batches
        follow it.  metadata is stamped into every checkpoint.  `mesh`
        trains data-parallel over its data ranks."""
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        if not comm.is_main():
            loop_cfg = dataclasses.replace(loop_cfg, tensorboard=False,
                                           wandb_project=None,
                                           profile_dir=None)
        self.loop_cfg = loop_cfg
        self.update_freq = update_freq
        self.metadata = dict(metadata or {})
        self.device = resolve_device(device)
        self.state = create_train_state(model.to(self.device), optim_cfg,
                                        mesh=self.mesh)
        if update_freq > 1:
            self.grad_step, self.apply_step = make_accum_train_step(
                loss_fn, optim_cfg, freeze_until)
        else:
            self.train_step = make_train_step(loss_fn, optim_cfg,
                                              freeze_until=freeze_until)
        self.valid_fn = valid_fn
        self.best = None
        self.bad_epochs = 0
        os.makedirs(loop_cfg.save_dir, exist_ok=True)
        self.log_path = os.path.join(loop_cfg.save_dir, "train_log.jsonl")
        self.sinks = make_sinks(loop_cfg)

    def log(self, record: Dict):
        if not comm.is_main():
            return
        record = {k: (float(v) if isinstance(v, torch.Tensor) else v)
                  for k, v in record.items()}
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(json.dumps(record), flush=True)
        for sink in self.sinks:
            sink(record)

    def _maybe_save_best(self, metrics: Dict[str, float],
                         count_patience: bool = False):
        cfg = self.loop_cfg
        value = metrics.get(cfg.best_metric)
        if value is None:
            return
        better = self.best is None or (value > self.best if
                                       cfg.maximize_metric else
                                       value < self.best)
        name = f"checkpoint.best_{cfg.best_metric}_{value:.4f}"
        if comm.is_main():
            save_checkpoint(os.path.join(cfg.save_dir, name),
                            self.state.model.state_dict(),
                            metadata={**self.metadata,
                                      "step": self.state.step})
        if better:
            self.best = value
            self.bad_epochs = 0
        elif count_patience:
            # fairseq --patience counts epoch-end validations without
            # improvement; mid-epoch validations checkpoint only
            self.bad_epochs += 1
        if comm.is_main():
            keep = set(find_best_checkpoints(cfg.save_dir, cfg.keep_best,
                                             maximize=cfg.maximize_metric))
            for f in os.listdir(cfg.save_dir):
                p = os.path.join(cfg.save_dir, f)
                if re.match(r"checkpoint\.best_", f) and p not in keep:
                    os.remove(p)
        comm.barrier()

    def _to_device(self, batch: Dict) -> Dict:
        if self.mesh is not None:
            batch = mesh_lib.shard_batch(self.mesh, batch)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def fit(self, batch_iter_fn: Callable[[int], Iterable[Dict]]):
        """batch_iter_fn(epoch) -> iterator of batches (arrays or tensors)."""
        cfg = self.loop_cfg
        generator = torch.Generator().manual_seed(comm.fold_seed(
            cfg.seed, 0 if self.mesh is None else self.mesh.index("data")))
        t0 = time.time()
        updates = self.state.step             # nonzero after resume()
        profile_at = updates + PROFILE_WARMUP if cfg.profile_dir else -1
        accum, n_accum = None, 0

        def run_update(fn, *args):
            if updates != profile_at:
                return fn(*args)
            out, path = profile_update(lambda: fn(*args), self.device,
                                       cfg.profile_dir)
            self.log({"profile_trace": path, "update": updates + 1})
            return out
        for epoch in range(cfg.max_epochs):
            for batch in batch_iter_fn(epoch):
                for key in ("ids", "n_real", "indices"):
                    batch.pop(key, None)
                batch = self._to_device(batch)
                if self.update_freq > 1:
                    accum = sum_metrics(accum, self.grad_step(
                        self.state, batch, generator))
                    n_accum += 1
                    if n_accum < self.update_freq:
                        continue
                    self.state, metrics = run_update(self.apply_step,
                                                     self.state, accum)
                    accum, n_accum = None, 0
                else:
                    self.state, metrics = run_update(
                        self.train_step, self.state, batch, generator)
                updates += 1
                if updates % cfg.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    rec = {"epoch": epoch, "update": updates,
                           "loss": m["loss"] / max(m.get("sample_size", 1.0),
                                                   1.0),
                           "gnorm": m.get("gnorm", 0.0),
                           "ups": updates / (time.time() - t0),
                           **summarize_metrics(metrics)}
                    if m.get("skipped"):
                        rec["skipped"] = m["skipped"]
                    self.log(rec)
                if updates % cfg.validate_interval_updates == 0:
                    self.validate(updates)
                if updates >= cfg.max_updates:
                    self.validate(updates)
                    return self.state
            # end of epoch: the patience-counting validation
            self.validate(updates, count_patience=True)
            if cfg.patience and self.bad_epochs >= cfg.patience:
                self.log({"early_stop": updates, "epoch": epoch})
                return self.state
        return self.state

    def validate(self, updates: int, count_patience: bool = False):
        self.save_last()
        if self.valid_fn is None:
            return
        with torch.no_grad():
            metrics = self.valid_fn(self.state.model)
        self.log({"valid_update": updates, **metrics})
        self._maybe_save_best(metrics, count_patience=count_patience)

    def save_last(self):
        """Resumable state (params + optimizer + step), fairseq's
        checkpoint_last."""
        if comm.is_main():
            save_checkpoint(
                os.path.join(self.loop_cfg.save_dir, "checkpoint_resume"),
                {"params": self.state.model.state_dict(),
                 "opt_state": self.state.opt.state_dict(),
                 "step": self.state.step}, metadata=self.metadata)
        comm.barrier()

    def resume(self, path: str) -> int:
        """Every rank reads the checkpoint; the first rank's parameters and
        moments are then broadcast, so that the ranks start equal."""
        restored, _ = load_checkpoint(path, map_location=self.device)
        self.state.model.load_state_dict(restored["params"])
        self.state.opt.load_state_dict(restored["opt_state"])
        self.state.step = int(restored["step"])
        if self.mesh is not None:
            comm.replicate(self.mesh, self.state.model)
            comm.replicate(self.mesh, self.state.opt.mu +
                           self.state.opt.nu)
        return self.state.step
