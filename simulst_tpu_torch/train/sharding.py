"""Tensor-parallel parameter shardings over the mesh's `model` axis
(counterpart of simulst_tpu/train/sharding.py, the same path rules).

The widest products are split over the ranks of the `model` axis: `fc1`
on its output columns ((d, ffn) -> (d, ffn / M)), `fc2` on its input rows
((ffn, d) -> (ffn / M, d)), the fused Emformer `emb_to_key_value` on its
columns ((d, 2d) -> (d, 2d / M)); the vocabulary matrices (the embedding,
the CTC head, the output projection) and every bias stay whole, as in
JAX.  Each rank stores, updates and keeps the Adam moments of its slice
only.

The kernels read these weights whole: the LN-FFN and FFN kernels take
fc1 and fc2 in one piece, and the attention kernel takes K and V, which
the KV product's columns give.  So each sharded weight is a
parametrization (torch.nn.utils.parametrize) that all-gathers its slices
over `model` where the forward reads it, and whose backward
reduce-scatters the gradient back to the slices, as GSPMD does around a
Pallas call, which has no partitioning rule.  No product is split
Megatron-style: the KV product is a plain torch one, but its output
would need the same all-gather before the attention.  A Megatron split
inside the fused LN-FFN kernel needs a variant of the kernel without the
residual and the output dropout (ROADMAP, speed list).

The ranks of a model group train on the same rows, so the gradients of
the whole parameters agree there and train/state.py sums them over
`data` only; its global norm sums the slices' squares over `model`
(`split`), so that each parameter counts once.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.nn.utils import parametrize

from simulst_tpu_torch import comm

# module name suffix -> the weight's dimension split over `model`
# (weights are stored (in, out))
RULES = {"fc1": 1, "fc2": 0, "emb_to_key_value": 1}


def spec_for(module_name: str):
    """The split dimension of the module's weight, or None (whole)."""
    leaf = module_name.rsplit(".", 1)[-1]
    return RULES.get(leaf)


class Gathered(nn.Module):
    """The parametrization of a sharded weight: its stored slice ->
    the whole weight, all-gathered over the axis."""

    def __init__(self, mesh: comm.Mesh, axis: str, dim: int):
        super().__init__()
        self.mesh, self.axis, self.dim = mesh, axis, dim

    def forward(self, shard):
        return comm.all_gather(self.mesh, shard, self.axis, self.dim)

    def right_inverse(self, full):
        return comm.shard_rows(self.mesh, full, self.axis,
                               self.dim).clone()


def shard_parameters(model: nn.Module, mesh: comm.Mesh,
                     axis: str = "model") -> Dict[str, str]:
    """Shard the model's fc1 / fc2 / emb_to_key_value weights over `axis`
    in place (the JAX package's param_shardings).  Returns the `split` map
    of train/state.create_train_state: stored parameter name -> axis."""
    if mesh.size(axis) == 1:
        return {}
    for name, module in list(model.named_modules()):
        dim = spec_for(name)
        if dim is None or getattr(module, "weight", None) is None:
            continue
        parametrize.register_parametrization(
            module, "weight", Gathered(mesh, axis, dim), unsafe=True)
    return {name: axis for name, _ in model.named_parameters()
            if name.endswith("parametrizations.weight.original")}


@torch.no_grad()
def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict with every sharded weight whole under its
    own name (a collective: every rank of the axis calls it)."""
    out = {}
    for key, value in model.state_dict().items():
        if key.endswith("parametrizations.weight.original"):
            owner = model.get_submodule(key[:-len(
                ".parametrizations.weight.original")])
            out[key[:-len("parametrizations.weight.original")] + "weight"] = \
                owner.weight.detach().clone()
        else:
            out[key] = value
    return out
