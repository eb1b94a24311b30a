"""Sequence packing for Emformer training (counterpart of
simulst_tpu/train/packing.py).

Bucketed batches pad every utterance to its bucket's length, and the
Emformer stack then computes over the padding.  Its attention is
segment-local, so short utterances can share a row at segment
granularity: a packed row holds several examples, and per-segment example
ids gate the attention so that no query sees another example's keys
(nn/emformer.py `make_packed_eids`, the id gate of
ops/emformer_attn.py's kernels).

A packed forward equals the padded one on every valid frame (dropout off):
  * the conv frontend (subsampler + conv-pos) runs UNPACKED on the padded
    layout; only the Emformer stack runs packed;
  * examples start at segment boundaries and dead frames are zero, so the
    per-segment summary means match the padded batch's;
  * the right-context gather fetches ZERO rows at example boundaries,
    exactly what a padded batch reads beyond an example's length;
  * the attention's per-example length rule becomes example-id equality.
With dropout the packed run draws its masks in the packed layout.

The plan is built on the host in numpy (`pack_plan`); `pack_frames` and
`unpack_frames` are torch gathers over the flattened frame axis, on the
tensors' device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class PackPlan(NamedTuple):
    """Gather maps of one batch: numpy int32 arrays from `pack_plan`, or
    the same arrays as tensors on the card once a batch is there.  Row and
    row-length information rides in the shapes.

    All "flat" indices address the (B*U,)-flattened frame axis, with B*U
    the zero-row sentinel (the gathers append one zero row)."""
    frame_gather: np.ndarray   # (R, Up) -> flat source frame | B*U
    frame_eid: np.ndarray      # (R, Up) example id | -1 dead
    seg_eid: np.ndarray        # (R, n_p) example id | -1 dead
    rc_gather: np.ndarray      # (R, n_p*rc) -> flat PACKED frame | R*Up
    unpack_gather: np.ndarray  # (B, U) -> flat packed frame | R*Up


def plan_capacity(lengths, seg: int) -> int:
    """Total segments needed to pack these (post-subsample) lengths."""
    lengths = np.asarray(lengths)
    return int(np.ceil(lengths / seg).sum())


def _ffd_rows(items, cap: int) -> int:
    """First-fit-decreasing bin count for `items` into bins of `cap`."""
    free = []
    for it in sorted(items, reverse=True):
        for i, f in enumerate(free):
            if f >= it:
                free[i] -= it
                break
        else:
            free.append(cap - it)
    return len(free)


def choose_row_segments(lengths, seg: int, candidates) -> int:
    """Row length (in segments) minimizing total packed slots (rows x n_p)
    over `candidates`, by FFD simulation.  With length-sorted buckets every
    example is near the bucket length, so rows of the bucket's length pair
    nothing; rows sized for 2-3 examples recover most of the padding.  Ties
    prefer the smallest n_p."""
    segs = np.ceil(np.asarray(lengths) / seg).astype(np.int64)
    best = None
    for n_p in candidates:
        if n_p < segs.max():
            continue
        slots = _ffd_rows(list(segs), n_p) * n_p
        if best is None or slots < best[0] or \
                (slots == best[0] and n_p < best[1]):
            best = (slots, n_p)
    if best is None:
        raise ValueError("no usable row length among the candidates")
    return best[1]


def usable_row_segments(ecfg, n_min: int, n_max: int):
    """Row segment counts in [n_min, n_max] whose geometry keeps the grouped
    attention (G > 1: the grouped-attention kernel)."""
    from simulst_tpu_torch.nn.emformer import _choose_group
    return [n for n in range(n_min, n_max + 1)
            if _choose_group(n, n * ecfg.segment, ecfg) > 1]


def pack_plan(lengths, U: int, seg: int, rc: int,
              n_rows: Optional[int] = None,
              row_segs: Optional[int] = None) -> PackPlan:
    """First-fit-decreasing segment-granular bin packing of B examples with
    post-subsample `lengths` (padded source layout (B, U)) into rows of
    `row_segs` segments (default U // seg).  n_rows=None sizes the plan to
    the rows FFD needs; a fixed n_rows raises if the examples do not fit."""
    lengths = np.asarray(lengths, np.int64)
    B = len(lengths)
    if U % seg:
        raise ValueError(f"U {U} is not a whole number of {seg}-frame "
                         "segments")
    n_p = row_segs or U // seg
    Up = n_p * seg
    segs = np.ceil(lengths / seg).astype(np.int64)
    if segs.max() > n_p:
        raise ValueError("an example exceeds the packed row length")

    cap = B if n_rows is None else n_rows
    order = np.argsort(-segs, kind="stable")
    free = np.full(cap, n_p, np.int64)
    place = np.zeros((B, 2), np.int64)          # (row, seg offset)
    used = 0
    for e in order:
        need = int(segs[e])
        fit = np.nonzero(free >= need)[0]
        if fit.size == 0:
            raise ValueError(
                f"batch needs more than {cap} rows of {n_p} segments "
                f"(total segments {int(segs.sum())})")
        r = int(fit[0])
        place[e] = (r, n_p - free[r])
        free[r] -= need
        used = max(used, r + 1)
    if n_rows is None:
        n_rows = used

    sentinel = B * U
    frame_gather = np.full((n_rows, Up), sentinel, np.int64)
    frame_eid = np.full((n_rows, Up), -1, np.int64)
    seg_eid = np.full((n_rows, n_p), -1, np.int64)
    unpack = np.full((B, U), n_rows * Up, np.int64)
    for e in range(B):
        r, o = place[e]
        length = int(lengths[e])
        p0 = o * seg
        frame_gather[r, p0: p0 + length] = e * U + np.arange(length)
        frame_eid[r, p0: p0 + length] = e
        seg_eid[r, o: o + segs[e]] = e
        unpack[e, :length] = r * Up + p0 + np.arange(length)

    # right-context blocks: segment s of a row reads frames
    # [(s+1)*seg, (s+1)*seg + rc) of the SAME example, else zero rows, as
    # the padded batch reads zero content there.  Ownership is checked PER
    # FRAME: with rc > seg the window spans segment s+2 and beyond, and at
    # a row's end it would overrun into the next row
    rc_gather = np.full((n_rows, n_p * rc), n_rows * Up, np.int64)
    for r in range(n_rows):
        for s in range(n_p):
            if seg_eid[r, s] < 0:
                continue
            for i in range(rc):
                j = (s + 1) * seg + i
                owner = j // seg
                if owner < n_p and seg_eid[r, owner] == seg_eid[r, s]:
                    rc_gather[r, s * rc + i] = r * Up + j
    return PackPlan(frame_gather=frame_gather.astype(np.int32),
                    frame_eid=frame_eid.astype(np.int32),
                    seg_eid=seg_eid.astype(np.int32),
                    rc_gather=rc_gather.astype(np.int32),
                    unpack_gather=unpack.astype(np.int32))


def _gather_rows(x, index):
    """x (N, D) with one zero row appended, rows taken at `index` (any
    shape, values in [0, N])."""
    idx = torch.as_tensor(index, device=x.device).long()
    flat = torch.cat([x, x.new_zeros(1, x.shape[1])])
    return flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                         x.shape[1])


def pack_frames(x, plan: PackPlan):
    """x: (B, U, D) post-frontend features (zero beyond each length) ->
    (packed (R, Up, D), rc_blocks (R, n_p*rc, D))."""
    b, u, d = x.shape
    fg = torch.as_tensor(plan.frame_gather, device=x.device).clamp_max(b * u)
    packed = _gather_rows(x.reshape(b * u, d), fg)
    rc = _gather_rows(packed.reshape(-1, d), plan.rc_gather)
    return packed, rc


def unpack_frames(packed, plan: PackPlan):
    """(R, Up, D) -> (B, U, D) in the plan's source layout; dead positions
    come back as zeros."""
    return _gather_rows(packed.reshape(-1, packed.shape[-1]),
                        plan.unpack_gather)
