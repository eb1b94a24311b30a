"""Full-model pipeline-parallel training (counterpart of
simulst_tpu/train/pipeline.py): the GPipe schedule over a `pipe` axis.

`pipelined_train_loss` stages the whole joint-CTC train step: stage 0 runs
the frontend (the conv subsampler, the scale and the conv-pos, `_frontend`)
on each microbatch, the microbatches hop stage to stage through the
Emformer layers (nn/emformer.pipeline_ticks), and the last stage runs the
epilogue (the final layer norm, the CTC head, the teacher-forced decoder
and the joint CTC loss, `_epilogue`).  The summed loss and metrics are
summed over the pipe ranks, so the loss drops into
train/state.make_train_step, whose update sums them over the data ranks
as for any other loss: the optimizer, the clip and the non-finite skip
run unchanged on the pipelined gradients.

The JAX package's SPMD program runs the frontend and the epilogue masked
on every stage; here each rank runs only its own part, and
`pipeline_stage` keeps on each rank only the parameters its stage reads
(the frontend on stage 0, the decoder, the CTC head and the final layer
norm on the last), so every parameter lives on one stage: the train
state's `split` sums their squares over `pipe` for the global norm.
The reference trains with data parallelism only (SURVEY.md §2.6).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from simulst_tpu_torch import comm
from simulst_tpu_torch.losses.joint_ctc import JointCTCConfig, joint_ctc_loss
from simulst_tpu_torch.models import s2t_emformer as s2t
from simulst_tpu_torch.nn import emformer as emf
from simulst_tpu_torch.nn import transformer as tfm
from simulst_tpu_torch.nn.conv import conv_out_length
from simulst_tpu_torch.nn.core import (RngStream, layer_norm,
                                       lengths_to_mask, linear)

FRONTEND = ("encoder.subsample", "encoder.conv_pos")
EPILOGUE = ("decoder", "encoder.ctc_layer", "encoder.emformer.final_ln")


def pipeline_stage(model: s2t.S2TEmformerModel, mesh: comm.Mesh,
                   pipe_axis: str = "pipe") -> Dict[str, str]:
    """Keep on this rank only what its stage reads, in place: its Emformer
    layers (under their global indices), the frontend on stage 0, the
    epilogue's modules on the last stage.  Returns the `split` map of
    train/state.create_train_state (every parameter is a stage's)."""
    n_stage, stage = mesh.size(pipe_axis), mesh.index(pipe_axis)
    if n_stage == 1:
        return {}
    emf.keep_stage_layers(model.encoder.emformer, mesh, pipe_axis)
    drop = (FRONTEND if stage != 0 else ()) + \
        (EPILOGUE if stage != n_stage - 1 else ())
    for path in drop:
        owner, name = path.rsplit(".", 1) if "." in path else ("", path)
        setattr(model.get_submodule(owner), name, None)
    return {name: pipe_axis for name, _ in model.named_parameters()}


def _frontend(enc: s2t.S2TEmformerEncoder, cfg: s2t.S2TEmformerConfig,
              feats, feat_lengths, rngs: Optional[RngStream], idx):
    """encoder_forward's pre-Emformer section and the (utterance, rc
    blocks, mems) of the layer stack's input, packed in one tensor."""
    ecfg = cfg.emformer
    x, lengths = s2t._frontend(enc, cfg, feats, feat_lengths, rngs)
    x = torch.nn.functional.pad(x, (0, 0, 0, ecfg.right_context))
    U = x.shape[1] - ecfg.right_context
    utterance = x[:, :U]
    n = emf._num_segs(U, ecfg.segment)
    mems = (emf._segment_means(utterance, ecfg.segment)[:, :n - 1]
            if ecfg.use_mem else utterance[:, :0])
    return emf._pack(utterance, x.index_select(1, idx), mems)


def _epilogue(model: s2t.S2TEmformerModel, cfg: s2t.S2TEmformerConfig,
              lcfg: JointCTCConfig, enc, enc_lens, prev_tokens, target,
              rngs: Optional[RngStream]):
    """Last-stage work: final LN -> CTC head -> decoder -> joint CTC loss."""
    if cfg.emformer.normalize_before:
        enc = layer_norm(model.encoder.emformer.final_ln, enc)
    ctc_logits = (None if model.encoder.ctc_layer is None
                  else linear(model.encoder.ctc_layer, enc))
    logits = tfm.decoder_forward(model.decoder, cfg.decoder, prev_tokens, enc,
                                 lengths_to_mask(enc_lens, enc.shape[1]),
                                 rngs=rngs)
    return joint_ctc_loss(logits, {"ctc_logits": ctc_logits,
                                   "encoder_lengths": enc_lens}, target, lcfg)


def out_lengths(cfg: s2t.S2TEmformerConfig, lengths):
    """The frontend's output lengths (the subsampler's stride-2 causal
    convolutions), without its parameters, which stage 0 alone holds."""
    for k in cfg.conv_kernel_sizes:
        lengths = conv_out_length(lengths, k, 2)
    return lengths


def pipelined_train_loss(model: s2t.S2TEmformerModel,
                         cfg: s2t.S2TEmformerConfig, lcfg: JointCTCConfig,
                         batch: Dict, mesh: comm.Mesh,
                         pipe_axis: str = "pipe",
                         data_axis: Optional[str] = None,
                         n_micro: Optional[int] = None,
                         rngs: Optional[RngStream] = None):
    """The pipelined equivalent of joint_ctc_loss(model(...)).

    batch: feats (B, T, F), lengths (B,), prev (B, L), target (B, L), the
    whole batch on every rank (JAX's keys); `model` this rank's stage
    (`pipeline_stage`).  Returns (summed loss, metrics) of this data
    rank's rows, both summed over the pipe ranks and equal on each of
    them: the make_train_step loss_fn contract (its update sums them over
    `data_axis`; a psum there would add nothing to the gradients, as
    psum's backward is the identity).  Without
    dropout the loss and every gradient equal the dense path's; with
    `rngs` each (layer, microbatch) and each microbatch's frontend and
    epilogue draw their own masks."""
    if not lcfg.zero_infinity:
        raise ValueError("pipelined_train_loss requires "
                         "JointCTCConfig.zero_infinity")
    ecfg = cfg.emformer
    n_stage, stage = mesh.size(pipe_axis), mesh.index(pipe_axis)
    layers = emf.stage_layers(model.encoder.emformer, ecfg, mesh, pipe_axis)
    feats = batch["feats"]
    B, T = feats.shape[:2]
    n_micro = n_micro or n_stage
    n_data = mesh.size(data_axis) if data_axis else 1
    rows = torch.as_tensor(emf.microbatch_rows(
        B, n_micro, n_data, mesh.index(data_axis) if data_axis else 0),
        device=feats.device)
    loc = rows.numel() // n_micro
    local = {k: batch[k].index_select(0, rows)
             for k in ("feats", "lengths", "prev", "target")}
    U = int(out_lengths(cfg, torch.tensor(T)))
    idx = torch.as_tensor(emf._rc_gather_indices(U, ecfg.segment,
                                                 ecfg.right_context),
                          device=feats.device)
    n = emf._num_segs(U, ecfg.segment)
    width = U + idx.numel() + (n - 1 if ecfg.use_mem else 0)
    like = torch.zeros(loc, width, cfg.embed_dim, dtype=cfg.dtype,
                       device=feats.device)
    base = None if rngs is None else rngs.next()

    def part(key, m):
        return local[key][m * loc:(m + 1) * loc]

    def stream(tag, m):
        return None if base is None else RngStream(torch.Generator(
        ).manual_seed(comm.fold_seed(base, tag, m + 1)))

    def inject(m):
        return _frontend(model.encoder, cfg, part("feats", m),
                         part("lengths", m), stream(10 ** 6, m), idx)

    def stage_fn(act, m):
        out = emf.run_stage(layers, ecfg, *emf._unpack(act, U, idx.numel()),
                            out_lengths(cfg, part("lengths", m)),
                            None if base is None else (base, m))
        return emf._pack(*out)

    losses, metrics = [], []

    def finish(act, m):
        loss, met = _epilogue(model, cfg, lcfg, act[:, :U],
                              out_lengths(cfg, part("lengths", m)),
                              part("prev", m), part("target", m),
                              stream(2 * 10 ** 6, m))
        losses.append(loss)
        metrics.append(met)

    anchor = emf.pipeline_ticks(mesh, pipe_axis, n_micro, inject, stage_fn,
                                finish, like)
    last = n_stage - 1
    if stage == last:
        loss = torch.stack([l.float() for l in losses]).sum()
        keys = sorted(metrics[0])
        vec = torch.stack([sum(torch.as_tensor(m[k], device=feats.device)
                               .double() for m in metrics) for k in keys])
    else:
        loss = torch.zeros((), device=feats.device)
        keys, vec = None, None
    if n_stage > 1:
        box = [keys]
        dist.broadcast_object_list(box, mesh.members[pipe_axis][last],
                                   group=mesh.group(pipe_axis))
        keys = box[0]
        if vec is None:
            vec = torch.zeros(len(keys), dtype=torch.float64,
                              device=feats.device)
        # a stage without the epilogue still runs its shifts' backward
        loss = comm.depend(loss, anchor)
    loss = comm.psum(mesh, loss, [pipe_axis])
    vec = comm.all_reduce_(mesh, vec, [pipe_axis])
    return loss, {k: v.float() for k, v in zip(keys, vec)}

