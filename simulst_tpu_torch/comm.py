"""Process groups of a parallel run and their collectives: the layer
below nn/, data/ and train/ that replaces the JAX package's device mesh
(simulst_tpu/train/mesh.py) and the collectives XLA inserts.

The JAX package lays its devices out on a named mesh and lets XLA insert
the collectives; here every rank is a process, and a `Mesh` holds the
`torch.distributed` groups of a 2-D layout: `data` (outer) and one inner
axis, `model` (tensor parallelism, train/sharding.py), `pipe` (pipeline
stages, train/pipeline.py) or `seq` (segments of the sequence-sharded
Emformer).  Rank r sits at (r // inner, r % inner), as JAX reshapes its
device list to (n_data, n_model).

Ranks start under torchrun (its RANK / WORLD_SIZE / LOCAL_RANK
environment, `init_from_environment`) or from `spawn`, which the tests
and the dry run (multichip.py) use.  Each rank runs on its own card over
NCCL; on the CPU, and where the machine has fewer cards than ranks (two
ranks sharing one card), over gloo, whose point-to-point operations take
CPU tensors only, so every collective of a CUDA tensor is staged through
the host there.

The collectives are the JAX ones the parallel paths use.  Those a
gradient flows through are autograd Functions, written for the SPMD rule
that every rank of a group runs the same program: `psum` (its backward
is the identity, since every rank backpropagates the same summed value),
`shift` (lax.ppermute by one place; its backward is the opposite shift),
`all_gather` (its backward reduce-scatters the mean: the ranks of the
group go on to compute the same thing on the gathered tensor, so each
holds the whole gradient) and `replicate_from` (a broadcast whose
backward keeps the source's own gradient).  Point-to-point transfers go
through `batch_isend_irecv`, each rank posting its send and its receive
together, so that no pair of ranks waits on the other.  Data-parallel
training's own helpers (a rank's rows of a batch, replicating a model,
the writing rank) are in train/mesh.py.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

INNER_AXES = ("model", "pipe", "seq")


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, inner) layout and its groups."""
    shape: Dict[str, int]                 # {"data": n, inner: m}
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, object]             # axis -> ProcessGroup (size > 1)
    members: Dict[str, List[int]]         # axis -> global ranks, by index

    @property
    def world(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        if axis not in self.members:
            return 0
        return self.members[axis].index(self.rank)

    def group(self, axis: str):
        return self.groups.get(axis)


def fold_seed(seed: int, *indices: int) -> int:
    """A seed for the (indices) shard of a run seeded with `seed`, as
    jax.random.fold_in folds an axis index into a key: the seed itself
    for all-zero indices, so rank 0 draws what one process draws."""
    for i in indices:
        if i:
            seed = (seed * 0x9E3779B1 + i * 0x85EBCA6B + 1) % (2 ** 62)
    return seed


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _pick_backend(device, local_rank: int, local_world: int):
    """(device, backend) of a rank: NCCL when each rank has a card of its
    own, gloo on the CPU and where ranks share a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev, "gloo"
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device; pass device='cpu'")
    dev = torch.device("cuda", local_rank % n)
    torch.cuda.set_device(dev)
    if n >= local_world:
        return dev, "nccl"
    if local_rank == 0:
        print(f"mesh: {local_world} ranks share {n} card(s) over gloo "
              "(collectives staged through the host)", flush=True)
    return dev, "gloo"


def init_distributed(rank: int, world: int, init_method: str, device=None,
                     local_rank: Optional[int] = None,
                     local_world: Optional[int] = None):
    """init_process_group for this rank; returns (device, backend)."""
    local_rank = rank if local_rank is None else local_rank
    local_world = world if local_world is None else local_world
    dev, backend = _pick_backend(device, local_rank, local_world)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    _STATE.update(device=dev, backend=backend,
                  nodes=max(world // local_world, 1),
                  node=rank // local_world, local_world=local_world)
    return dev, backend


def init_from_environment(device=None):
    """Under torchrun (WORLD_SIZE > 1 in the environment): join the
    process group and return (device, backend); otherwise None."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    return init_distributed(
        int(os.environ["RANK"]), world, "env://", device,
        int(os.environ.get("LOCAL_RANK", "0")),
        int(os.environ.get("LOCAL_WORLD_SIZE", str(world))))


# the process's device and backend, and its node among the run's nodes
_STATE: Dict[str, object] = {}


def node_shards():
    """(number of nodes, this node's index): torchrun's node count and
    GROUP_RANK, the counterpart of jax.process_count() / process_index();
    (1, 0) outside a parallel run."""
    if not dist.is_initialized():
        return 1, 0
    return int(_STATE.get("nodes", 1)), int(_STATE.get("node", 0))


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              inner: str = "model") -> Mesh:
    """The (data, inner) mesh over the first n_data * n_model ranks of the
    running process group (every rank calls it; the groups are made in the
    same order everywhere).  n_data defaults to world // n_model; inner
    names the second axis: "model", "pipe" or "seq"."""
    if inner not in INNER_AXES:
        raise ValueError(f"inner axis {inner!r} is not one of {INNER_AXES}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model > world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs "
                         f"{n_data * n_model} ranks, the run has {world}")
    groups, members = {}, {}
    data_sets = [[d * n_model + m for d in range(n_data)]
                 for m in range(n_model)]
    inner_sets = [[d * n_model + m for m in range(n_model)]
                  for d in range(n_data)]
    for axis, sets in (("data", data_sets), (inner, inner_sets)):
        for ranks in sets:
            g = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                members[axis] = ranks
                if g is not None:
                    groups[axis] = g
    return Mesh(shape={"data": n_data, inner: n_model}, rank=rank,
                device=_STATE.get("device", torch.device("cpu")),
                backend=str(_STATE.get("backend", "gloo")), groups=groups,
                members=members)


def shard_rows(mesh: Mesh, x: torch.Tensor, axis: str = "data",
               dim: int = 0) -> torch.Tensor:
    """This rank's block of `dim`: rows i*n/W .. (i+1)*n/W of the axis's
    W ranks, as shard_map splits an array over a mesh axis."""
    w, i = mesh.size(axis), mesh.index(axis)
    n = x.shape[dim]
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} {axis} ranks")
    return x.narrow(dim, i * (n // w), n // w)


@torch.no_grad()
def replicate(mesh: Mesh, tensors, axis: str = "data") -> None:
    """Broadcast the first rank's values of `tensors` (a module's
    parameters and buffers, or a list) to every rank of the axis."""
    if mesh.size(axis) == 1:
        return
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    src = mesh.members[axis][0]
    for t in tensors:
        buf = _host(mesh, t.detach())
        dist.broadcast(buf, src, group=mesh.group(axis))
        if buf is not t:
            t.copy_(buf)


def is_main() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process outside a parallel run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of a parallel run (nothing outside one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown(mesh: Optional[Mesh]) -> None:
    """Wait for every rank, then leave the process group."""
    if mesh is not None and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """t on the device its backend reduces on: the host for gloo, this
    rank's card for NCCL (a copy where t lies elsewhere)."""
    dev = torch.device("cpu") if mesh.backend == "gloo" else mesh.device
    return t if t.device == dev else t.to(dev)


def all_reduce_(mesh: Mesh, t: torch.Tensor, axes: Sequence[str]) -> \
        torch.Tensor:
    """Sum `t` over the ranks of every axis in `axes`, in place (no
    gradient); returns it."""
    for axis in axes:
        if mesh.size(axis) == 1:
            continue
        buf = _host(mesh, t.detach())
        dist.all_reduce(buf, group=mesh.group(axis))
        if buf is not t:
            with torch.no_grad():
                t.copy_(buf)
    return t


def all_reduce_flat_(mesh: Mesh, tensors: List[torch.Tensor],
                     axes: Sequence[str]) -> None:
    """all_reduce_ of a list of tensors of one dtype as one collective."""
    if not tensors or all(mesh.size(a) == 1 for a in axes):
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(mesh, flat, axes)
    with torch.no_grad():
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view(t.shape))


def _gather_raw(mesh: Mesh, x: torch.Tensor, axis: str, dim: int):
    parts = [torch.empty_like(_host(mesh, x)) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, _host(mesh, x.contiguous()),
                    group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(x.device)


def all_gather_nograd(mesh: Mesh, x: torch.Tensor, axis: str = "data",
                      dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of the axis, concatenated along `dim` in
    rank order."""
    if mesh.size(axis) == 1:
        return x
    if x.dtype == torch.bool:
        return _gather_raw(mesh, x.detach().to(torch.uint8), axis, dim).bool()
    return _gather_raw(mesh, x.detach(), axis, dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce_(mesh, x.detach().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(mesh: Mesh, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """lax.psum over `axes`: every rank gets the sum; the backward is the
    identity, as every rank backpropagates the same summed value."""
    axes = [a for a in axes if mesh.size(a) > 1]
    return _PSum.apply(x, mesh, axes) if axes else x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_raw(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, w = ctx.mesh, ctx.axis, ctx.mesh.size(ctx.axis)
        g = all_reduce_(mesh, g.contiguous().clone(), [axis]) / w
        return shard_rows(mesh, g, axis, ctx.dim).contiguous(), None, None, \
            None


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
    """lax.all_gather(tiled) along `dim`; the backward reduce-scatters the
    mean of the ranks' gradients (the ranks then compute the same thing on
    the gathered tensor, so each holds the whole gradient)."""
    if mesh.size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim)


def _exchange(mesh: Mesh, axis: str, send: Optional[torch.Tensor],
              send_to: Optional[int], recv_from: Optional[int],
              like: torch.Tensor) -> Optional[torch.Tensor]:
    """Post this rank's send (to index send_to) and receive (from index
    recv_from) of the axis together; returns the received tensor."""
    members, group = mesh.members[axis], mesh.group(axis)
    ops, buf = [], None
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, _host(mesh, send.contiguous()),
                              members[send_to], group))
    if recv_from is not None:
        buf = torch.empty_like(_host(mesh, like))
        ops.append(dist.P2POp(dist.irecv, buf, members[recv_from], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return None if buf is None else buf.to(like.device)


def _shift_raw(mesh, axis, x, offset, cyclic):
    w, i = mesh.size(axis), mesh.index(axis)
    dst, src = i + offset, i - offset
    if cyclic:
        dst, src = dst % w, src % w
    got = _exchange(mesh, axis, x, dst if 0 <= dst < w else None,
                    src if 0 <= src < w else None, x)
    return torch.zeros_like(x) if got is None else got


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, mesh, axis, offset, cyclic):
        ctx.args = (mesh, axis, offset, cyclic)
        ctx.token_like = token
        return _shift_raw(mesh, axis, x.detach(), offset, cyclic)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, offset, cyclic = ctx.args
        gx = _shift_raw(mesh, axis, g.contiguous(), -offset, cyclic)
        gt = None if ctx.token_like is None else torch.zeros_like(
            ctx.token_like)
        return gx, gt, None, None, None, None


def shift(mesh: Mesh, x: torch.Tensor, axis: str, offset: int = 1,
          cyclic: bool = False, token: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """lax.ppermute by `offset` places along the axis: the rank at index i
    receives the x of index i - offset (zeros where there is none, unless
    cyclic).  The backward is the opposite shift.  `token` (optional, a
    tensor of the previous shift's output) makes this shift's backward
    run after that one's on every rank, whatever the activations feed:
    a chain of shifts then exchanges its gradients in one order on every
    rank of the axis."""
    if mesh.size(axis) == 1:
        return x if cyclic else torch.zeros_like(x)
    if x.requires_grad or (token is not None and token.requires_grad):
        return _Shift.apply(x, token, mesh, axis, offset, cyclic)
    return _shift_raw(mesh, axis, x.detach(), offset, cyclic)


def shift_from_left(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Each rank receives its LEFT neighbour's x; the first gets zeros."""
    return shift(mesh, x, axis, 1)


def shift_from_right(mesh: Mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Each rank receives its RIGHT neighbour's x; the last gets zeros."""
    return shift(mesh, x, axis, -1)


class _ReplicateFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, mesh, axis, src):
        ctx.is_src = mesh.index(axis) == src
        ctx.anchor_like = anchor
        buf = _host(mesh, x.detach().contiguous().clone())
        dist.broadcast(buf, mesh.members[axis][src], group=mesh.group(axis))
        return buf.to(x.device)

    @staticmethod
    def backward(ctx, g):
        ga = None if ctx.anchor_like is None else torch.zeros_like(
            ctx.anchor_like)
        return (g if ctx.is_src else None), ga, None, None, None


def replicate_from(mesh: Mesh, x: torch.Tensor, axis: str, src: int,
                   anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The x of the rank at index `src`, on every rank of the axis (x gives
    the shape elsewhere).  The ranks then compute the same thing on it, so
    the backward keeps the source's own gradient and gives the others
    none; `anchor` (a tensor of this rank's last shift) gets a zero
    gradient, which runs this rank's chain of shifts backward."""
    if mesh.size(axis) == 1:
        return x
    return _ReplicateFrom.apply(x, anchor, mesh, axis, src)


class _Depend(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor):
        ctx.anchor_like = anchor
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(ctx.anchor_like)


def depend(x: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """x, with a zero gradient to `anchor` in the backward: a rank whose
    loss does not read its last shift still runs the shifts' backward."""
    return _Depend.apply(x, anchor)


# ---------------------------------------------------------------------------
# spawning ranks (tests, the dry run)
# ---------------------------------------------------------------------------

def _spawned(rank, fn, world, init_method, device, args, out_dir, tf32):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    init_distributed(rank, world, init_method, device)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, args=(), device="cpu",
          timeout: float = 900.0) -> list:
    """Run fn(*args) on n_ranks fresh processes joined in one process group
    (a file rendezvous in a temporary directory, so concurrent runs never
    share a port) and return each rank's result, in rank order.  fn must
    be importable by name in a child (a module-level function of this
    package or of a module that imports neither JAX nor the JAX package);
    its result is saved with torch.save.  The ranks take this process's
    TF32 settings (a fresh process would let cuDNN's convolutions round
    their inputs to TF32).  Build the CUDA kernels before spawning: every
    rank then loads the one library.  Ranks still running after
    `timeout` seconds (ranks that wait on each other) are terminated and
    TimeoutError is raised."""
    import time

    import torch.multiprocessing as mp
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    with tempfile.TemporaryDirectory(prefix="simulst_spawn_") as out_dir:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        ctx = mp.start_processes(_spawned, args=(fn, n_ranks, init, device,
                                                 args, out_dir, tf32),
                                 nprocs=n_ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                    p.join(10)
                raise TimeoutError(f"{n_ranks} spawned ranks still running "
                                   f"after {timeout:.0f} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(n_ranks)]
