"""A data rank's rows of a host batch (counterpart of
simulst_tpu/train/mesh.py's shard_batch; the process groups, make_mesh
and the collectives are in simulst_tpu_torch/comm.py).

Each node of a run reads its own manifest shard (cli/train passes
make_batches the node's shard, as the JAX package shards per process),
so the ranks of one node read the same batches and split the rows of
each over the node's data ranks: rank i of the node's W takes rows
i*B/W .. (i+1)*B/W, as JAX splits axis 0 over `data`.  The batcher pads
a batch with rows after its `n_real` real ones; `local_rows` says which
of a rank's rows are real, by the same split.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from simulst_tpu_torch import comm


def local_rows(mesh: comm.Mesh, n: int) -> Tuple[int, int]:
    """(first row, count) of this rank's block of a node batch of n rows."""
    nodes, _ = comm.node_shards()
    local = max(mesh.size("data") // nodes, 1)
    if n % local:
        raise ValueError(f"{n} rows do not split over {local} data ranks")
    per = n // local
    return (mesh.index("data") % local) * per, per


def shard_batch(mesh: comm.Mesh, batch: Dict, dim: int = 0) -> Dict:
    """This rank's rows of every array of a node batch (the batcher's
    batch_multiple makes them divide).  An `n_real` entry, the count of
    real rows before the padding, becomes this rank's count of them."""
    arrays = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "n_real"}
    n = next(iter(arrays.values())).shape[dim]
    start, per = local_rows(mesh, n)
    out = {}
    for k, t in arrays.items():
        if t.shape[dim] != n:
            raise ValueError(f"{k}: {t.shape[dim]} rows, the batch {n}")
        out[k] = t.narrow(dim, start, per)
    if "n_real" in batch:
        out["n_real"] = min(max(int(batch["n_real"]) - start, 0), per)
    return out
