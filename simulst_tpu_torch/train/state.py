"""TrainState and the train step with microbatch accumulation
(counterpart of simulst_tpu/train/state.py).

The JAX package's step semantics, on an nn.Module: gradients of SUM losses
are summed over `update_freq` microbatches and divided by the summed
'sample_size' (fairseq); `freeze_until` zeroes a top-level component's
gradients while step < n (the reference's --encoder-freezing-updates); the
global-norm clip, Adam and the learning rate follow; a non-finite gradient
norm skips the whole update, so params, Adam moments and step stay put.
Gradients accumulate in each parameter's .grad and the update is made in
place; the decision to skip reads the norm on the host once per update.

Data parallelism (a `mesh` with data ranks, comm.py): each rank
accumulates the gradients of its rows, and `apply_update` SUMS the
gradients and every metric over the data ranks (one collective each per
update, whatever update_freq) before dividing by the global
'sample_size', as fairseq and the JAX package do (DistributedDataParallel
would average instead).  The norm, the clip and the non-finite skip then
read the same summed gradients on every rank, which so take the same
decision and stay bit for bit equal.  `split` names the parameters whose
ranks of an axis each hold a different part (tensor-parallel slices over
`model`, train/sharding.py; pipeline stages over `pipe`,
train/pipeline.py): their squares are summed over that axis for the
norm, so that each parameter counts once; the others' gradients are
averaged over the axis, which keeps them equal on its ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from simulst_tpu_torch import comm
from simulst_tpu_torch.nn.core import RngStream, step_casts
from simulst_tpu_torch.train.optim import (Adam, OptimConfig,
                                           clip_by_global_norm_, global_norm)


@dataclasses.dataclass
class TrainState:
    model: nn.Module        # the parameters
    opt: Adam               # the optimizer's moments and count
    step: int = 0           # updates made (skipped ones not counted)
    mesh: Optional[comm.Mesh] = None    # data ranks sum the gradients
    split: Dict[str, str] = dataclasses.field(default_factory=dict)


def create_train_state(model: nn.Module, optim_cfg: OptimConfig,
                       mesh: Optional[comm.Mesh] = None,
                       split: Optional[Dict[str, str]] = None) -> TrainState:
    """`split` maps a parameter name to the mesh axis whose ranks each
    hold a different part of it (the others are whole on every rank)."""
    return TrainState(model=model,
                      opt=Adam(list(model.parameters()), optim_cfg), step=0,
                      mesh=mesh, split=dict(split or {}))


def sum_metrics(acc: Optional[Dict], m: Dict) -> Dict:
    """Sum two metric dicts key by key (acc may be None)."""
    m = {k: torch.as_tensor(v).detach() for k, v in m.items()}
    return m if acc is None else {k: acc[k] + m[k] for k in acc}


def accumulate_grads(state: TrainState, loss_fn: Callable, batch: Dict,
                     rngs: Optional[RngStream]) -> Dict:
    """One microbatch: loss_fn(model, batch, rngs) -> (loss, metrics); the
    loss's gradient is added to each parameter's .grad; the parameters'
    casts to a compute dtype are made together (`step_casts`)."""
    with step_casts(state.model):
        loss, metrics = loss_fn(state.model, batch, rngs)
    loss.backward()
    return sum_metrics(None, metrics)


def sum_over(mesh: comm.Mesh, metrics: Dict, axes=("data",)) -> Dict:
    """Every metric summed over the ranks of `axes`, in one collective
    (float64, so that counts stay exact), each in its own dtype."""
    if all(mesh.size(a) == 1 for a in axes):
        return metrics
    keys = list(metrics)
    vals = [torch.as_tensor(metrics[k]).detach() for k in keys]
    flat = torch.stack([v.to(device=mesh.device, dtype=torch.float64)
                        .reshape(()) for v in vals])
    comm.all_reduce_(mesh, flat, axes)
    return {k: s.to(dtype=v.dtype, device=v.device)
            for k, v, s in zip(keys, vals, flat)}


def _reduce_grads(state: TrainState, named, grads) -> None:
    """Sum every gradient over the data ranks; over each other axis,
    average the gradients of the parameters that are not split on it: the
    ranks there computed them alike, and an average makes them bit for bit
    equal where kernels sum in an order of their own (cuDNN's)."""
    mesh = state.mesh
    for axis in mesh.shape:
        if mesh.size(axis) == 1:
            continue
        gs = [g for (name, _), g in zip(named, grads)
              if axis == "data" or state.split.get(name) != axis]
        by_dtype: Dict[torch.dtype, list] = {}
        for g in gs:
            by_dtype.setdefault(g.dtype, []).append(g)
        for part in by_dtype.values():
            comm.all_reduce_flat_(mesh, part, [axis])
            if axis != "data":
                torch._foreach_div_(part, float(mesh.size(axis)))


def _global_norm(state: TrainState, named, grads) -> torch.Tensor:
    """The gradients' global norm; a parameter split over an axis sums its
    squares over that axis's ranks, so each parameter counts once."""
    if not state.split:
        return global_norm(grads)
    by_axis: Dict[Optional[str], list] = {}
    for (name, _), g in zip(named, grads):
        by_axis.setdefault(state.split.get(name), []).append(g)
    total = None
    for axis, gs in by_axis.items():
        sq = global_norm(gs) ** 2
        if axis is not None:
            sq = comm.all_reduce_(state.mesh, sq.clone(), [axis])
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply_update(state: TrainState, metrics: Dict, optim_cfg: OptimConfig,
                 freeze_until: Optional[Dict[str, int]] = None):
    """Normalise the accumulated gradients, freeze, clip, Adam; skip on a
    non-finite norm.  Clears the gradients.  With data ranks the
    gradients and metrics are first summed over them.  Returns (state,
    metrics)."""
    named = list(state.model.named_parameters())
    params = [p for _, p in named]
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    mesh = state.mesh
    if mesh is not None:
        _reduce_grads(state, named, grads)
        metrics = sum_over(mesh, metrics)
    denom = max(float(metrics["sample_size"]), 1.0)
    torch._foreach_div_(grads, denom)
    if freeze_until:
        for (name, _), g in zip(named, grads):
            n = freeze_until.get(name.split(".")[0])
            if n is not None and state.step < n:
                g.zero_()
    gnorm = _global_norm(state, named, grads)
    ok = bool(torch.isfinite(gnorm))
    if ok:
        if optim_cfg.clip_norm > 0:
            clip_by_global_norm_(grads, optim_cfg.clip_norm, gnorm)
        state.opt.update_(params, grads)
        state.step += 1
    for p in params:
        p.grad = None
    metrics = dict(metrics, gnorm=gnorm.detach(),
                   skipped=torch.tensor(0.0 if ok else 1.0))
    return state, metrics


def make_train_step(loss_fn: Callable, optim_cfg: OptimConfig,
                    update_freq: int = 1,
                    freeze_until: Optional[Dict[str, int]] = None):
    """loss_fn(model, batch, rngs) -> (loss, metrics), loss a SUM with a
    'sample_size' metric.  Returns train_step(state, batch, generator) ->
    (state, metrics).  With update_freq > 1 every tensor of `batch` has a
    leading microbatch axis of that size.  generator (a CPU
    torch.Generator) seeds the dropout; None runs without dropout."""
    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None):
        rngs = None if generator is None else RngStream(generator)
        if update_freq == 1:
            metrics = accumulate_grads(state, loss_fn, batch, rngs)
        else:
            metrics = None
            for i in range(update_freq):
                mb = {k: v[i] for k, v in batch.items()}
                metrics = sum_metrics(
                    metrics, accumulate_grads(state, loss_fn, mb, rngs))
        return apply_update(state, metrics, optim_cfg, freeze_until)

    return train_step


def make_accum_train_step(loss_fn: Callable, optim_cfg: OptimConfig,
                          freeze_until: Optional[Dict[str, int]] = None):
    """Host-orchestrated accumulation for microbatches of differing shapes.
    Returns (grad_step, apply_step):
      grad_step(state, batch, generator) -> metrics   (adds to .grad)
      apply_step(state, metrics) -> (state, metrics)  (metrics summed)"""
    def grad_step(state: TrainState, batch: Dict,
                  generator: Optional[torch.Generator] = None):
        rngs = None if generator is None else RngStream(generator)
        return accumulate_grads(state, loss_fn, batch, rngs)

    def apply_step(state: TrainState, metrics: Dict):
        return apply_update(state, metrics, optim_cfg, freeze_until)

    return grad_step, apply_step
