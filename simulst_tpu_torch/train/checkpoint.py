"""Checkpoints: torch.save / torch.load in place of orbax, best-N selection
and averaging, conformed and component-wise pretrained init (counterpart of
simulst_tpu/train/checkpoint.py).

A checkpoint is one file holding {"state": ..., "metadata": {...}}, the
state a state_dict (or a dict of them: params, optimizer, step).
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch


def save_checkpoint(path: str, state, metadata: Optional[Dict] = None):
    """Write atomically: a reader never sees half a file."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"state": state, "metadata": metadata or {}}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, map_location="cpu"):
    """(state, metadata) of a checkpoint written by save_checkpoint."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return blob["state"], blob.get("metadata") or None


BEST_RE = re.compile(
    r"checkpoint\.best_(?P<metric>[^_]+)_(?P<value>[0-9.]+?)(\.pt)?$")


def find_best_checkpoints(directory: str, n: int = 5,
                          maximize: Optional[bool] = None) -> List[str]:
    """Best N by the metric in the file name `checkpoint.best_<metric>_
    <value>`; maximize=None infers the direction from the metric name (bleu
    maximises; loss, wer and latency minimise)."""
    cands = []
    metric = None
    for f in os.listdir(directory):
        m = BEST_RE.match(f)
        if m:
            cands.append((float(m.group("value")), os.path.join(directory, f)))
            metric = m.group("metric")
    if maximize is None:
        maximize = bool(metric and "bleu" in metric)
    cands.sort(key=lambda x: -x[0] if maximize else x[0])
    return [p for _, p in cands[:n]]


def average_params(state_dicts: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    """Uniform fp32 average of state_dicts with the same keys (checkpoint
    averaging)."""
    n = len(state_dicts)
    if n == 0:
        raise ValueError("average_params: no checkpoints")
    return {k: sum(sd[k].float() for sd in state_dicts) / n
            for k in state_dicts[0]}


def conform_state(template: Dict[str, torch.Tensor],
                  restored: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """restored's entries for exactly template's keys, in template's dtypes
    (the JAX package's conform_tree): a key that restored lacks raises, a
    key that template lacks (an ASR encoder's CTC head under an MMA
    encoder) is left behind."""
    missing = sorted(set(template) - set(restored))
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's "
                       f"parameters: {missing[:5]}")
    return {k: restored[k].to(template[k].dtype) for k in template}


def load_pretrained_component(state_dict: Dict[str, torch.Tensor],
                              component_state: Dict[str, torch.Tensor],
                              component: str) -> Dict[str, torch.Tensor]:
    """Component-wise init: the keys under `component.` taken from
    component_state (keyed without the prefix) by conform_state, the rest
    kept."""
    prefix = component + "."
    template = {k[len(prefix):]: v for k, v in state_dict.items()
                if k.startswith(prefix)}
    out = dict(state_dict)
    out.update({prefix + k: v for k, v in
                conform_state(template, component_state).items()})
    return out
