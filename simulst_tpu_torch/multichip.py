"""Multi-rank runs of the port's parallel paths, each held to the
single-process path it stands for: the counterpart of the JAX package's
dry run (`__graft_entry__.dryrun_multichip`, which jits the same paths over
a virtual device mesh).

    python -m simulst_tpu_torch.multichip --ranks 2 [--device cpu]

spawns the ranks (comm.spawn) and runs, on every rank:
  - the data-parallel (and, with 4 ranks, data x model tensor-parallel)
    joint-CTC train step (`train_steps`);
  - the sequence-sharded Emformer forward and its gradients
    (`seq_sharded`);
  - the pipelined Emformer forward and its gradients (`pipelined`);
  - the full-model pipelined train step, dp x pp with 4 ranks
    (`pipeline_train`);
  - the sharded evaluation: BLEU / WER statistics of manifest shards
    summed over the ranks (`sharded_eval`);
  - the sharded streaming: fused CIF sessions split over the data ranks
    (`sharded_streaming`);
  - the multi-host input: each rank's manifest shard as its rows of one
    global batch (`multihost_input`).
Each case computes the single-process result on the rank too and returns
both with their distance; the dry run raises when one is out of its
tolerance.  The cases take numpy arrays and state dicts and return them,
so the CPU tests call them through `spawn` and hold their results against
the JAX package as well.  On the card every rank launches the kernels;
the cases report each rank's kernel launches.
"""
from __future__ import annotations

import argparse
import copy
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from simulst_tpu_torch import comm
from simulst_tpu_torch.train import mesh as mesh_lib

ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true", "--no-specaugment"]
OPTIM = dict(lr=1e-3, warmup_updates=10000, clip_norm=10.0)   # exp/1a
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


def tiny_config(**overrides):
    """The JAX dry run's tiny s2t_emformer (s2t_emformer_s geometry, 2 + 2
    layers, 64 wide, 2 heads of 32, FFN 128, vocab 64), without dropout
    unless overridden."""
    from simulst_tpu_torch.models.s2t_emformer import S2TEmformerConfig
    kw = dict(vocab_size=64, input_feat=80, conv_channels=64, embed_dim=64,
              ffn_dim=128, encoder_layers=2, encoder_heads=2,
              decoder_layers=2, decoder_heads=2, decoder_ffn_dim=128,
              segment_length=16, left_context=32, right_context=8,
              max_memory=2, ctc_layer=True, **NO_DROPOUT)
    kw.update(overrides)
    return S2TEmformerConfig(**kw)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ops_wrappers():
    from simulst_tpu_torch.ops import (cif_integrate, conv_pos, ctc,
                                       emformer_attn, ffn, linear_res, mha,
                                       monotonic_align)
    for mod in (ffn, emformer_attn, linear_res, mha, conv_pos, ctc,
                monotonic_align, cif_integrate):
        for name, fn in vars(mod).items():
            for attr in ("launches", "gated_launches"):
                if callable(fn) and isinstance(getattr(fn, attr, None), int):
                    yield (name if attr == "launches" else
                           name.replace("_backward", "") + "_gated" +
                           ("_backward" if name.endswith("_backward")
                            else ""), fn, attr)


def reset_launches() -> None:
    for _, fn, attr in _ops_wrappers():
        setattr(fn, attr, 0)


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches since the last reset (0 everywhere
    on the CPU, where the wrappers run their plain versions)."""
    return {name: getattr(fn, attr) for name, fn, attr in _ops_wrappers()}


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _tensors(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()}


def _load(module: torch.nn.Module, params: Optional[Dict]):
    if params is not None:
        module.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                for k, v in params.items()})
    return module


def _s2t(cfg, params, device, seed: int = 0):
    from simulst_tpu_torch.models.s2t_emformer import S2TEmformerModel
    return _load(S2TEmformerModel(
        cfg, generator=torch.Generator().manual_seed(seed), device=device),
        params)


def rel_err(got, want, scale=None) -> float:
    """max |got - want| over the largest |want| (or |scale|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    return float(np.abs(got - want).max() / max(ref, 1e-30))


# biases whose key part has an exact gradient of 0 (a key bias adds one
# q.b to every score of a row): both sides hold rounding noise there
KEY_BIASES = ("k_proj.bias", "emb_to_key_value.bias")


def grads_errs(got: Dict, want: Dict) -> Dict[str, float]:
    """rel_err of each gradient `want` names; a key bias is held to its
    weight's largest entry."""
    missing = sorted(set(want) - set(got))
    if missing:
        raise AssertionError(f"gradients missing: {missing[:5]}")
    return {k: rel_err(got[k], v, want.get(k[:-len("bias")] + "weight")
                       if k.endswith(KEY_BIASES) else None)
            for k, v in want.items()}


def grads_err(got: Dict, want: Dict) -> float:
    """The largest of `grads_errs`."""
    return max(grads_errs(got, want).values())


def worst(errs: Dict[str, float], n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(
        errs.items(), key=lambda kv: -kv[1])[:n])


def _gather_dicts(d: Dict) -> Dict:
    """Every rank's dict merged (a collective): a key held by several
    ranks keeps the lowest rank's value."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return d
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, d)
    out = {}
    for part in parts:
        for k, v in part.items():
            out.setdefault(k, v)
    return out


def _named_grads(model) -> Dict[str, torch.Tensor]:
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


SHARDED = ".parametrizations.weight.original"


def whole_grads(model, mesh, grads: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """`grads` (by stored parameter name) with each tensor-parallel slice's
    gradient all-gathered over `model` into the whole weight's, under the
    weight's own name (a collective, as sharding.full_state_dict is for
    the weights); the other gradients as they are."""
    out = {}
    for name, g in grads.items():
        if name.endswith(SHARDED):
            owner = model.get_submodule(name[:-len(SHARDED)])
            name = name[:-len(SHARDED)] + ".weight"
            g = comm.all_gather_nograd(mesh, g, "model",
                                       owner.parametrizations.weight[0].dim)
        out[name] = g
    return out


def _asr_loss():
    from simulst_tpu_torch.cli import train as tcli
    return tcli.build_loss(tcli.parse_args(ASR_ARGS), None)


# ---------------------------------------------------------------------------
# the cases (run on every rank of a spawned group)
# ---------------------------------------------------------------------------

def update_batch(full: Dict, update_freq: int, u: int, nan_update,
                  nan_rank: int, n_data: int) -> Dict:
    """Update u's batch: `update_freq` microbatches (rows rotated by 3 per
    microbatch) stacked on a leading axis when update_freq > 1; at update
    `nan_update` the feats of the first microbatch's rows that data rank
    `nan_rank` takes are NaN."""
    B = full["feats"].shape[0]
    mbs = []
    for i in range(update_freq):
        rows = torch.as_tensor((np.arange(B) + 3 * (u * update_freq + i)) % B,
                               device=full["feats"].device)
        mb = {k: v.index_select(0, rows) for k, v in full.items()}
        if u == nan_update and i == 0:
            per = B // n_data
            mb["feats"] = mb["feats"].clone()
            mb["feats"][nan_rank * per:(nan_rank + 1) * per] = float("nan")
        mbs.append(mb)
    if update_freq == 1:
        return mbs[0]
    return {k: torch.stack([mb[k] for mb in mbs]) for k in full}


def train_steps(cfg, params: Optional[Dict], batch: Dict,
                n_data: Optional[int] = None, n_model: int = 1,
                update_freq: int = 1, updates: int = 1,
                nan_update: Optional[int] = None, nan_rank: int = 1,
                optim: Optional[Dict] = None, reference: bool = True,
                seed: int = 0) -> Dict:
    """The data-parallel (x tensor-parallel over `model`) joint-CTC train
    step of cli/train's model and loss.  Returns the summed loss and the
    whole gradients of one accumulation over the batch (each rank's rows,
    summed over the data ranks; the tensor-parallel slices all-gathered
    over `model`, `whole_grads`), the launches of that accumulation, each
    update's metrics and the whole parameters after `updates` updates;
    with `reference`, rank 0 also runs the one-process path from the same
    parameters and batches."""
    from simulst_tpu_torch.train.optim import OptimConfig
    from simulst_tpu_torch.train.sharding import (full_state_dict,
                                                  shard_parameters)
    from simulst_tpu_torch.train.state import (accumulate_grads,
                                               create_train_state,
                                               make_train_step, sum_over)
    mesh = comm.make_mesh(n_data, n_model)
    dev = mesh.device
    loss_fn = _asr_loss()
    ocfg = OptimConfig(**(optim or OPTIM))
    model = _s2t(cfg, params, dev, seed)
    ref = copy.deepcopy(model) if reference and mesh.rank == 0 else None
    split = shard_parameters(model, mesh) if n_model > 1 else {}
    state = create_train_state(model, ocfg, mesh=mesh, split=split)
    full = _tensors(batch, dev)
    out: Dict = {"rank": mesh.rank, "backend": mesh.backend,
                 "device": str(dev)}
    reset_launches()
    metrics = accumulate_grads(state, loss_fn,
                               mesh_lib.shard_batch(mesh, full), None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["launches"] = launch_counts()
    grads = _named_grads(model)
    comm.all_reduce_flat_(mesh, list(grads.values()), ["data"])
    metrics = sum_over(mesh, metrics)
    out["loss"] = float(metrics["loss"])
    out["grads"] = {k: _np(g) for k, g in
                    whole_grads(model, mesh, grads).items()}
    for p in model.parameters():
        p.grad = None
    if ref is not None:
        loss, _ = loss_fn(ref, full, None)
        loss.backward()
        out["ref_loss"] = float(loss.detach())
        out["ref_grads"] = {k: _np(g) for k, g in _named_grads(ref).items()}
        for p in ref.parameters():
            p.grad = None
    step = make_train_step(loss_fn, ocfg, update_freq=update_freq)
    hist = []
    reset_launches()
    t0 = time.perf_counter()
    for u in range(updates):
        b = update_batch(full, update_freq, u, nan_update, nan_rank,
                          mesh.size("data"))
        b = mesh_lib.shard_batch(mesh, b, dim=0 if update_freq == 1 else 1)
        state, m = step(state, b)
        hist.append({k: float(m[k]) for k in ("loss", "gnorm", "skipped",
                                                "sample_size")})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["s"] = time.perf_counter() - t0
    out["update_launches"] = launch_counts()
    out["history"], out["step"] = hist, state.step
    out["params"] = {k: _np(v) for k, v in full_state_dict(model).items()}
    if ref is not None:
        ref_state = create_train_state(ref, ocfg)
        ref_hist = []
        for u in range(updates):
            b = update_batch(full, update_freq, u, nan_update, nan_rank,
                              mesh.size("data"))
            ref_state, m = step(ref_state, b)
            ref_hist.append({k: float(m[k]) for k in
                             ("loss", "gnorm", "skipped", "sample_size")})
        out["ref_history"], out["ref_step"] = ref_hist, ref_state.step
        out["ref_params"] = {k: _np(v) for k, v in ref.state_dict().items()}
    return out


def _emformer(ecfg, params, dev):
    from simulst_tpu_torch.nn.emformer import Emformer
    return _load(Emformer(ecfg, generator=torch.Generator().manual_seed(0)),
                 params).to(dev)


def seq_sharded(ecfg, params: Optional[Dict], x: np.ndarray,
                lengths: np.ndarray, weight: np.ndarray, n_data: int = 1,
                reference: bool = True) -> Dict:
    """emformer_forward_seq_sharded over a (data, seq) mesh of the whole
    world: the output (gathered), the gradients of sum(out * weight) for
    every parameter and for x (summed over the ranks), the launches, and
    on rank 0 the one-process emformer_forward's."""
    from simulst_tpu_torch.nn import emformer as emf
    world = dist.get_world_size()
    mesh = comm.make_mesh(n_data, world // n_data, inner="seq")
    dev = mesh.device
    p = _emformer(ecfg, params, dev)
    ref = copy.deepcopy(p) if reference and mesh.rank == 0 else None
    xt = torch.tensor(x, device=dev, requires_grad=True)
    lens = torch.as_tensor(lengths, device=dev)
    w = torch.as_tensor(weight, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    out = emf.emformer_forward_seq_sharded(
        p, ecfg, xt, lens, mesh, data_axis="data" if n_data > 1 else None)
    S, U = mesh.size("seq"), x.shape[1] - ecfg.right_context
    u_loc = U // S
    w_loc = w[:, mesh.index("seq") * u_loc:(mesh.index("seq") + 1) * u_loc]
    if n_data > 1:
        w_loc = comm.shard_rows(mesh, w_loc, "data")
    (out * w_loc).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = {"launches": launch_counts(), "s": time.perf_counter() - t0}
    grads = _named_grads(p)
    grads["x"] = xt.grad
    comm.all_reduce_flat_(mesh, list(grads.values()), ["data", "seq"])
    full = comm.all_gather_nograd(mesh, out, "seq", dim=1)
    full = comm.all_gather_nograd(mesh, full, "data", dim=0)
    res.update(out=_np(full), grads={k: _np(g) for k, g in grads.items()})
    if ref is not None:
        xr = torch.tensor(x, device=dev, requires_grad=True)
        o = emf.emformer_forward(ref, ecfg, xr, lens)
        (o * w).sum().backward()
        rg = _named_grads(ref)
        rg["x"] = xr.grad
        res.update(ref_out=_np(o), ref_grads={k: _np(g)
                                              for k, g in rg.items()})
    return res


def pipelined(ecfg, params: Optional[Dict], x: np.ndarray,
              lengths: np.ndarray, weight: np.ndarray, n_data: int = 1,
              n_micro: Optional[int] = None, reference: bool = True) -> Dict:
    """emformer_forward_pipelined over a (data, pipe) mesh of the whole
    world, each rank keeping only its stage's layers: the output rows of
    each data rank (gathered into batch order), the gradients of
    sum(out * weight) (each stage's layers from their stage, summed over
    the data ranks), and on rank 0 the one-process emformer_forward's."""
    from simulst_tpu_torch.nn import emformer as emf
    world = dist.get_world_size()
    mesh = comm.make_mesh(n_data, world // n_data, inner="pipe")
    dev = mesh.device
    p = _emformer(ecfg, params, dev)
    ref = copy.deepcopy(p) if reference and mesh.rank == 0 else None
    emf.keep_stage_layers(p, mesh)
    xt = torch.tensor(x, device=dev, requires_grad=True)
    lens = torch.as_tensor(lengths, device=dev)
    n_micro = n_micro or mesh.size("pipe")
    rows = emf.microbatch_rows(x.shape[0], n_micro, n_data,
                               mesh.index("data"))
    w = torch.as_tensor(weight, device=dev)[torch.as_tensor(rows,
                                                             device=dev)]
    reset_launches()
    out = emf.emformer_forward_pipelined(
        p, ecfg, xt, lens, mesh, n_micro=n_micro,
        data_axis="data" if n_data > 1 else None)
    (out * w).sum().backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    res = {"launches": launch_counts()}
    grads = _named_grads(p)
    grads["x"] = xt.grad if xt.grad is not None else torch.zeros_like(xt)
    comm.all_reduce_flat_(mesh, list(grads.values()), ["data"])
    comm.all_reduce_(mesh, grads["x"], ["pipe"])
    got = np.zeros((x.shape[0],) + tuple(out.shape[1:]), np.float32)
    for d in range(n_data):
        part = _np(comm.all_gather_nograd(mesh, out, "data")[
            d * out.shape[0]:(d + 1) * out.shape[0]])
        got[emf.microbatch_rows(x.shape[0], n_micro, n_data, d)] = part
    held = {k: _np(g) for k, g in grads.items()
            if k == "x" or k.startswith("layers.") or
            mesh.index("pipe") == 0}
    res.update(out=got, grads=_gather_dicts(held))
    if ref is not None:
        xr = torch.tensor(x, device=dev, requires_grad=True)
        o = emf.emformer_forward(ref, ecfg, xr, lens)
        (o * torch.as_tensor(weight, device=dev)).sum().backward()
        rg = _named_grads(ref)
        rg["x"] = xr.grad
        res.update(ref_out=_np(o), ref_grads={k: _np(g)
                                              for k, g in rg.items()})
    return res


def pipeline_train(cfg, params: Optional[Dict], batch: Dict,
                   n_data: int = 1, n_micro: Optional[int] = None,
                   optim: Optional[Dict] = None, reference: bool = True,
                   seed: int = 0) -> Dict:
    """pipelined_train_loss over a (data, pipe) mesh of the whole world:
    the summed loss, metrics and every gradient (merged from the stages,
    summed over the data ranks), then one make_train_step update's
    parameters; rank 0 also runs the dense joint_ctc_loss(model(...)) and
    its update.  batch: feats, lengths, prev, target (JAX's keys)."""
    from simulst_tpu_torch.losses.joint_ctc import (JointCTCConfig,
                                                    joint_ctc_loss)
    from simulst_tpu_torch.train.optim import OptimConfig
    from simulst_tpu_torch.train.pipeline import (pipeline_stage,
                                                  pipelined_train_loss)
    from simulst_tpu_torch.train.state import (create_train_state,
                                               make_train_step, sum_over)
    world = dist.get_world_size()
    mesh = comm.make_mesh(n_data, world // n_data, inner="pipe")
    dev = mesh.device
    lcfg = JointCTCConfig()
    ocfg = OptimConfig(**(optim or OPTIM))
    model = _s2t(cfg, params, dev, seed)
    ref = copy.deepcopy(model) if reference and mesh.rank == 0 else None
    split = pipeline_stage(model, mesh)
    full = _tensors(batch, dev)
    data_axis = "data" if n_data > 1 else None

    def loss_fn(m, b, rngs):
        return pipelined_train_loss(m, cfg, lcfg, b, mesh,
                                    data_axis=data_axis, n_micro=n_micro,
                                    rngs=rngs)
    reset_launches()
    t0 = time.perf_counter()
    loss, metrics = loss_fn(model, full, None)
    loss.backward()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    metrics = sum_over(mesh, metrics)     # the data ranks' rows together
    res = {"launches": launch_counts(), "s": time.perf_counter() - t0,
           "loss": float(metrics["loss"]),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    grads = _named_grads(model)
    comm.all_reduce_flat_(mesh, list(grads.values()), ["data"])
    res["grads"] = _gather_dicts({k: _np(g) for k, g in grads.items()})
    for p in model.parameters():
        p.grad = None
    state = create_train_state(model, ocfg, mesh=mesh, split=split)
    state, m = make_train_step(loss_fn, ocfg)(state, full)
    res["update"] = {k: float(m[k]) for k in ("loss", "gnorm", "skipped")}
    res["params"] = _gather_dicts({k: _np(v)
                                   for k, v in model.state_dict().items()})
    if ref is not None:
        def dense(m, b, rngs):
            logits, extra = m(b["feats"], b["lengths"], b["prev"], rngs=rngs)
            return joint_ctc_loss(logits, extra, b["target"], lcfg)
        rl, rm = dense(ref, full, None)
        rl.backward()
        res.update(ref_loss=float(rl.detach()),
                   ref_metrics={k: float(v) for k, v in rm.items()},
                   ref_grads={k: _np(g) for k, g in _named_grads(ref).items()})
        for p in ref.parameters():
            p.grad = None
        rs, m = make_train_step(dense, ocfg)(create_train_state(ref, ocfg),
                                             full)
        res["ref_update"] = {k: float(m[k]) for k in
                             ("loss", "gnorm", "skipped")}
        res["ref_params"] = {k: _np(v) for k, v in ref.state_dict().items()}
    return res


def sharded_streaming(kind: str, cfg, params: Optional[Dict],
                      chunks: List[np.ndarray], max_tokens: int = 32,
                      reference: bool = True, eos_scale: float = 1.0) -> Dict:
    """The fused CIF ("cif") or MMA ("mma") chunk step over B sessions
    split over the data ranks (stream/fused.sharded_sessions): the
    gathered tokens and counts, and on rank 0 the one-process batch's.
    `eos_scale` scales EOS's embedding row (a random model then writes
    before it ends)."""
    from simulst_tpu_torch.models import cif as cif_mod
    from simulst_tpu_torch.models import mma as mma_mod
    from simulst_tpu_torch.stream import fused
    mesh = comm.make_mesh()
    dev = mesh.device
    if kind == "cif":
        model = cif_mod.CIFModel(cfg, generator=torch.Generator(
        ).manual_seed(0), device=dev)
        step = fused.make_cif_fused_step(_load(model, params), cfg)

        def init(b):
            return fused.cif_fused_init(model, cfg, max_tokens, batch=b)
    else:
        model = mma_mod.MMAModel(cfg, generator=torch.Generator(
        ).manual_seed(0), device=dev)
        step = fused.make_mma_fused_step(_load(model, params), cfg)

        def init(b):
            return fused.mma_fused_init(model, cfg, max_src=64,
                                        max_tokens=max_tokens, batch=b)
    model.eval()
    with torch.no_grad():
        model.decoder.embed_tokens.weight[cfg.eos_idx] *= eos_scale

    def run_local(*local):
        state = init(local[0].shape[0])
        for i, ch in enumerate(local):
            state, _ = step(state, ch, finish=i == len(local) - 1)
        return state
    full = [torch.as_tensor(c, device=dev) for c in chunks]
    reset_launches()
    t0 = time.perf_counter()
    tokens, n_tokens, finished, truncated = fused.sharded_sessions(
        mesh, run_local, full)
    res = {"launches": launch_counts(), "s": time.perf_counter() - t0,
           "tokens": _np(tokens), "n_tokens": _np(n_tokens),
           "finished": _np(finished), "truncated": _np(truncated)}
    if reference and mesh.rank == 0:
        st = run_local(*full)
        res.update(ref_tokens=_np(st.tokens), ref_n_tokens=_np(st.n_tokens))
    return res


def _speech_dataset(rows, symbols, max_tokens: int = 4096):
    from simulst_tpu_torch.data.dataset import BatcherConfig, SpeechDataset
    from simulst_tpu_torch.data.vocab import Vocabulary
    bcfg = BatcherConfig(max_tokens=max_tokens, shuffle=False, cmvn="none")
    return SpeechDataset(rows, Vocabulary(list(symbols)), bcfg, "tgt_text")


def sharded_eval(cfg, params: Optional[Dict], rows: List[Dict],
                 symbols: List[str], max_len: int = 12) -> Dict:
    """cli/generate's greedy decode over the manifest, each data rank
    decoding its shard (make_batches(num_shards, shard_id)); the BLEU /
    WER statistics summed over the ranks, and the unsharded pass's."""
    from simulst_tpu_torch.cli.generate import decode_batch
    from simulst_tpu_torch.data.dataset import make_batches
    from simulst_tpu_torch.data.vocab import EOS, PAD
    from simulst_tpu_torch.decode.beam import BeamConfig
    from simulst_tpu_torch.decode.scoring import score_stats
    mesh = comm.make_mesh()
    dev = mesh.device
    model = _s2t(cfg, params, dev).eval()
    ds = _speech_dataset(rows, symbols)
    beam = BeamConfig(beam_size=1, max_len=max_len)

    def decode(shard_id, num_shards):
        refs, hyps = [], []
        for b in make_batches(ds, num_shards=num_shards, shard_id=shard_id):
            n_real = b.pop("n_real")
            b.pop("ids")
            with torch.no_grad():
                toks, lens = decode_batch(model, _tensors(
                    {"feats": b["feats"], "feat_lengths": b["feat_lengths"]},
                    dev), beam)
            toks, lens = _np(toks), _np(lens)
            for j in range(n_real):
                hyps.append(ds.vocab.decode_ids(
                    [int(t) for t in toks[j][:int(lens[j])] if t != EOS]))
                refs.append(ds.vocab.decode_ids(
                    [int(t) for t in b["target"][j] if t not in (PAD, EOS)]))
        return refs, hyps
    reset_launches()
    stats = score_stats(*decode(mesh.index("data"), mesh.size("data")))
    res = {"launches": launch_counts()}
    stats = comm.all_reduce_(mesh, stats.to(dev), ["data"])
    refs, hyps = decode(0, 1)
    res.update(stats=_np(stats), ref_stats=_np(score_stats(refs, hyps)),
               refs=refs, hyps=hyps)
    return res


def node_valid(cfg, params: Optional[Dict], rows: List[Dict],
               symbols: List[str], nodes: int = 2) -> Dict:
    """cli/train's validation (the loss and the inline greedy WER) with the
    ranks laid out as `nodes` nodes of world / nodes ranks: each node
    reads its manifest shard, as cli/train passes make_batches, and its
    ranks split the rows of every batch, real ones and padding
    (train/mesh.shard_batch), the statistics summed over the ranks; and
    the one-process validation of the whole manifest.  `texts` are the
    reference and hypothesis texts every rank scored (gathered, sorted):
    the rows validated.  The node layout is set on this rank's
    process-group state for the call (one host runs every rank)."""
    from simulst_tpu_torch.cli import train as tcli
    from simulst_tpu_torch.data.dataset import make_batches
    mesh = comm.make_mesh()
    dev = mesh.device
    model = _s2t(cfg, params, dev).eval()
    ds = _speech_dataset(rows, symbols)
    args = tcli.parse_args(ASR_ARGS + ["--eval-metric", "wer",
                                       "--eval-max-len", "12"])
    loss_fn = tcli.build_loss(args, None)
    node = mesh.rank // (mesh.world // nodes)
    saved = dict(comm._STATE)
    comm._STATE.update(nodes=nodes, node=node)
    mine, every = _TextRecorder(ds.vocab), _TextRecorder(ds.vocab)
    try:
        with torch.no_grad():
            got = tcli.build_valid_fn(
                args, mine, loss_fn, lambda: make_batches(
                    ds, num_shards=nodes, shard_id=node), dev, mesh)(model)
            want = tcli.build_valid_fn(args, every, loss_fn,
                                       lambda: make_batches(ds), dev)(model)
    finally:
        comm._STATE.clear()
        comm._STATE.update(saved)
    parts = [None] * mesh.world
    dist.all_gather_object(parts, mine.texts)
    return {"valid": got, "ref_valid": want,
            "texts": sorted(t for part in parts for t in part),
            "ref_texts": sorted(every.texts)}


class _TextRecorder:
    """A vocabulary that records every text it decodes."""

    def __init__(self, vocab):
        self.vocab, self.texts = vocab, []

    def decode_ids(self, ids):
        text = self.vocab.decode_ids(ids)
        self.texts.append(text)
        return text


def multihost_input(cfg, params: Optional[Dict], rows: List[Dict],
                    symbols: List[str]) -> Dict:
    """Each data rank reads its manifest shard's first batch
    (make_batches(num_shards, shard_id), zip members through the native
    loader) as its rows of one global batch; the loss per sample_size
    summed over the ranks, and that of the same rows in one process."""
    from simulst_tpu_torch.data.dataset import make_batches
    mesh = comm.make_mesh()
    dev = mesh.device
    model = _s2t(cfg, params, dev)
    ds = _speech_dataset(rows, symbols, max_tokens=10 ** 6)
    loss_fn = _asr_loss()
    keys = ("feats", "feat_lengths", "prev_tokens", "target")
    hosts = [next(make_batches(ds, num_shards=mesh.size("data"),
                               shard_id=h)) for h in range(mesh.size("data"))]
    with torch.no_grad():
        mine = _tensors({k: hosts[mesh.index("data")][k] for k in keys}, dev)
        loss, m = loss_fn(model, mine, None)
        sums = torch.stack([loss.double(),
                            torch.as_tensor(m["sample_size"]).double()
                            .to(dev)])
        comm.all_reduce_(mesh, sums, ["data"])
        whole = _tensors({k: np.concatenate([h[k] for h in hosts])
                          for k in keys}, dev)
        rl, rm = loss_fn(model, whole, None)
    return {"loss": float(sums[0] / sums[1]),
            "ref_loss": float(rl) / float(rm["sample_size"]),
            "rows": int(whole["feats"].shape[0])}


def run_cases(cases: List) -> Dict:
    """[(name, function name in this module, kwargs)] run in turn on this
    rank: {name: result} (the tests' one spawn per world)."""
    out = {}
    for name, fn, kw in cases:
        out[name] = globals()[fn](**kw)
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()    # ranks may share the card
    return out


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def synthetic_manifest(root: str, n: int, frames, n_words: int = 60,
                       seed: int = 0):
    """(rows, vocabulary symbols) of n utterances of seeded random fbank
    features in one zip (native-loader specs), `frames` frames each (an
    int, or a function of the index), with seeded short transcripts."""
    from simulst_tpu_torch.data import manifest as mf
    from simulst_tpu_torch.data.vocab import SPECIALS
    rs = np.random.RandomState(seed)
    feats = {}
    for i in range(n):
        t = frames(i) if callable(frames) else frames
        feats[f"u{i}"] = (rs.randn(t, 80) * 0.5).astype(np.float32)
    specs = mf.create_feature_zip(feats, os.path.join(root, "feats.zip"))
    words = [f"▁w{i}" for i in range(n_words)]
    rows = [{"id": k, "audio": specs[k], "n_frames": str(len(f)),
             "tgt_text": " ".join(f"w{(i + j) % 7}"
                                  for j in range(5 + i % 3))}
            for i, (k, f) in enumerate(feats.items())]
    return rows, list(SPECIALS) + words


def dryrun_batch(cfg, n_rows: int, T: int = 128, L: int = 8, seed: int = 0):
    """A seeded joint-CTC batch (cli/train keys), one row shorter."""
    rs = np.random.RandomState(seed)
    feats = (rs.randn(n_rows, T, cfg.input_feat) * 0.5).astype(np.float32)
    lengths = np.full((n_rows,), T, np.int64)
    lengths[-1] = T - 24
    feats[-1, T - 24:] = 0.0
    target = rs.randint(4, cfg.vocab_size, (n_rows, L)).astype(np.int64)
    target[:, -1] = cfg.eos_idx
    prev = np.roll(target, 1, axis=1)
    prev[:, 0] = cfg.eos_idx
    return {"feats": feats, "feat_lengths": lengths, "prev_tokens": prev,
            "target": target}


def streaming_config():
    """The JAX dry run's tiny CIF model: 1 + 1 layers, 16 wide, 2 heads of
    8, FFN 32, vocab 24 (the kernels take it padded: D and the hidden to
    64)."""
    from simulst_tpu_torch.models.cif import CIFConfig
    return CIFConfig(vocab_size=24, input_feat=8, conv_channels=16,
                     embed_dim=16, ffn_dim=32, encoder_layers=1,
                     encoder_heads=2, decoder_layers=1, decoder_heads=2,
                     decoder_ffn_dim=32, segment_length=16, left_context=32,
                     right_context=8, max_memory=2, **NO_DROPOUT)


def streaming_chunks(cfg, B: int, n_mid: int = 3, seed: int = 0):
    rs = np.random.RandomState(seed)
    seg, rc = cfg.segment_length, cfg.right_context
    out = [(rs.randn(B, seg + rc, cfg.input_feat) * 0.5).astype(np.float32)]
    out += [(rs.randn(B, seg, cfg.input_feat) * 0.5).astype(np.float32)
            for _ in range(n_mid)]
    return out


def lr_sum(history, optim: Optional[Dict] = None) -> float:
    """The learning rates of the updates made (skips not counted): Adam
    moves every entry by at most that much, whatever its gradient, so two
    runs part by at most twice it.  A sanity bound on the parameters: it
    does not test the gradients (`check_grads` does)."""
    from simulst_tpu_torch.train.optim import (OptimConfig,
                                               inverse_sqrt_schedule)
    sched = inverse_sqrt_schedule(OptimConfig(**(optim or OPTIM)))
    made = sum(1 for h in history if not h["skipped"])
    return sum(sched(c) for c in range(made))


def check_updates(res: Dict, skipped: List[float], lines: List[str],
                  name: str, optim: Optional[Dict] = None,
                  rtol: float = 1e-5) -> None:
    """A train_steps result against its one-process reference: the same
    skips, each update's loss and gradient norm within rtol, and the
    parameters within twice the learning rates' sum (`lr_sum`, a sanity
    bound that does not test the gradients: hold them with
    `check_grads`)."""
    got = [h["skipped"] for h in res["history"]]
    if got != skipped or got != [h["skipped"] for h in res["ref_history"]]:
        raise AssertionError(f"{name} skips {got}, one process "
                             f"{res['ref_history']}, expected {skipped}")
    for h, r in zip(res["history"], res["ref_history"]):
        if not h["skipped"]:
            check(f"{name} update loss", abs(h["loss"] / r["loss"] - 1),
                   rtol, lines)
            check(f"{name} update gnorm", abs(h["gnorm"] / r["gnorm"] - 1),
                   rtol, lines)
    err = max(float(np.abs(res["params"][k] - v).max())
              for k, v in res["ref_params"].items())
    check(f"{name} params after {len(got)} updates (abs)", err,
           2 * lr_sum(res["history"], optim), lines)


def check_grads(name: str, res: Dict, tol: float, lines: List[str]):
    """Every gradient of a case against its one-process reference, the
    worst three named."""
    errs = grads_errs(res["grads"], res["ref_grads"])
    check(f"{name} ({worst(errs)})", max(errs.values()), tol, lines)


def check(name: str, err: float, tol: float, lines: List[str]):
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} over {tol}")
    lines.append(f"{name}: {err:.3g} <= {tol:g}")


def dryrun_rank(data: Dict) -> Dict:
    """Every case of the dry run on this rank, each held to its
    single-process result (on rank 0); returns the checked distances,
    times and launches."""
    world, rank = dist.get_world_size(), dist.get_rank()
    cfg = tiny_config()
    lines: List[str] = []
    out: Dict = {"lines": lines}
    t0 = time.perf_counter()
    n_model = 2 if world >= 4 and world % 2 == 0 else 1
    n_data = world // n_model
    res = train_steps(cfg, None, data["batch"], n_data, n_model,
                      update_freq=2, updates=3, nan_update=1,
                      nan_rank=n_data - 1)
    out["train_launches"] = res.get("launches")
    params = _gather_dicts({rank: res["params"]})
    for r in range(1, world):
        for k, v in params[r].items():
            if not np.array_equal(v, params[0][k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's")
    if rank == 0:
        tag = "dp" if n_model == 1 else f"dp x tp ({n_data} x {n_model})"
        check(f"{tag} loss", abs(res["loss"] / res["ref_loss"] - 1), 1e-5,
              lines)
        check_grads(f"{tag} gradients", res, 1e-4, lines)
        check_updates(res, [0.0, 1.0, 0.0], lines, tag)
    ecfg = cfg.emformer
    seq_n = max(ecfg.max_memory, 2)
    U = world * seq_n * ecfg.segment
    rs = np.random.RandomState(1)
    x = (rs.randn(2, U + ecfg.right_context, cfg.embed_dim)).astype(
        np.float32)
    lengths = np.array([U, U - 7], np.int64)
    x[1, U - 7:U] = 0.0
    w = rs.randn(2, U, cfg.embed_dim).astype(np.float32)
    w[1, U - 7:] = 0.0
    res = seq_sharded(ecfg, None, x, lengths, w)
    out["seq_launches"] = res["launches"]
    if rank == 0:
        check("seq-sharded output", rel_err(res["out"][0], res["ref_out"][0]),
               1e-4, lines)
        check_grads("seq-sharded gradients", res, 1e-4, lines)
    xp = (rs.randn(4, 4 * ecfg.segment + ecfg.right_context,
                   cfg.embed_dim)).astype(np.float32)
    lp = np.full((4,), 4 * ecfg.segment, np.int64)
    wp = rs.randn(4, 4 * ecfg.segment, cfg.embed_dim).astype(np.float32)
    if ecfg.num_layers % world == 0:
        res = pipelined(ecfg, None, xp, lp, wp, n_micro=2)
        if rank == 0:
            check("pipelined output", rel_err(res["out"], res["ref_out"]),
                   1e-5, lines)
            check_grads("pipelined gradients", res, 1e-4, lines)
    if world >= 4 and world % 2 == 0 and ecfg.num_layers % 2 == 0:
        b = data["batch"]
        jb = {"feats": b["feats"], "lengths": b["feat_lengths"],
              "prev": b["prev_tokens"], "target": b["target"]}
        res = pipeline_train(cfg, None, jb, n_data=world // 2)
        if rank == 0:
            check("dp x pp loss", abs(res["loss"] / res["ref_loss"] - 1),
                   1e-5, lines)
            check_grads("dp x pp gradients", res, 1e-4, lines)
    res = sharded_eval(cfg, None, data["eval_rows"], data["symbols"])
    if rank == 0:
        if not np.array_equal(res["stats"], res["ref_stats"]):
            raise AssertionError(f"sharded BLEU / WER statistics "
                                 f"{res['stats']} != {res['ref_stats']}")
        lines.append(f"sharded eval: statistics equal over {world} shards "
                     f"({int(res['stats'][-1])} utterances)")
    scfg = streaming_config()
    res = sharded_streaming("cif", scfg, None,
                            streaming_chunks(scfg, 2 * world), eos_scale=0.1)
    if rank == 0:
        if not (np.array_equal(res["tokens"], res["ref_tokens"]) and
                np.array_equal(res["n_tokens"], res["ref_n_tokens"])):
            raise AssertionError("sharded streaming tokens differ from the "
                                 "single-process batch's")
        lines.append(f"sharded streaming: tokens equal ({2 * world} "
                     f"sessions, {int(res['n_tokens'].sum())} tokens)")
    res = multihost_input(cfg, None, data["host_rows"], data["symbols"])
    if rank == 0:
        check("multi-host input loss", abs(res["loss"] - res["ref_loss"]),
              1e-5, lines)
    out["s"] = time.perf_counter() - t0
    return out


def dryrun_data(root: str, world: int) -> Dict:
    """The dry run's batch and manifests (written under root)."""
    cfg = tiny_config()
    for sub in ("eval", "hosts"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    eval_rows, symbols = synthetic_manifest(
        os.path.join(root, "eval"), 4 * world, lambda i: 48 + 16 * (i % 3))
    host_rows, _ = synthetic_manifest(os.path.join(root, "hosts"),
                                      8 * world, 128, seed=1)
    return {"batch": dryrun_batch(cfg, 8 * world), "eval_rows": eval_rows,
            "host_rows": host_rows, "symbols": symbols}


def dryrun_multichip(n_ranks: int = 2, device="cuda") -> Dict:
    """The dry run on n_ranks spawned ranks: on the card each rank takes a
    card of its own (NCCL), or shares one over gloo where there are fewer;
    device="cpu" runs them on the CPU over gloo.  Raises when a case
    departs from its single-process result.  Returns rank 0's report."""
    if torch.device(device).type == "cuda":
        from simulst_tpu_torch.ops import _build
        _build.build()
        # fp32 products throughout, as chip_smoke.py compares them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="simulst_dryrun_") as root:
        data = dryrun_data(root, n_ranks)
        results = comm.spawn(dryrun_rank, n_ranks, (data,), device)
    report = results[0]
    report["s"] = time.perf_counter() - t0
    for line in report["lines"]:
        print(f"dryrun {line}", flush=True)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    report = dryrun_multichip(args.ranks, args.device)
    print(f"dryrun_multichip ok: {args.ranks} ranks in {report['s']:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
