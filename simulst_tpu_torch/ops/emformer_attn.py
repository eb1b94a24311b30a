"""Grouped-segment Emformer attention core (counterpart of
simulst_tpu/ops/emformer_attn_pallas.py `emformer_grouped_attention`,
forward and backward with attention dropout and the sequence-packing
example-id gate).

q3: (B, ng, nq, D) projected queries, rows [G rc blocks | G segments |
G summaries] per group; k/v: (B, Tk, D) projected rows of [mems (n-1) |
rc blocks (n*rc) | utterance (U)] at their exact Tk; lengths (B,) int32.
`gate`, for sequence-packed rows, is an `EidGate` of two int32 tensors on
q3's device: kid (B, Tk), the example id of each key row, and seg_eid
(B, n), the example id of each segment; a query row of segment s then
sees a key row only where seg_eid[b, s] == kid[b, row], besides the
length rule.  Equality is the whole rule (dead frames and segments carry
-1 and see each other).  Returns (B, ng, nq, D), before out_proj.  On a CUDA tensor the kernels of
csrc/emformer_attn.cu run, at any head dim D / heads (`check_head_dim`;
one that is not a multiple of 8 reaches them with each head zero-padded
to the next one, the real head dim beside it for the scale, and the
outputs are sliced back; above 128 the wide kernels, correct rather than
fast; in bf16 up to head dim 128 the backward on the tensor cores,
`bwd_plan`); on a CPU tensor `grouped_attention_plain` and
`grouped_attention_plain_backward`, the gathered-context formulation of
nn/emformer.py `_grouped_attention`.  Dropout on the probabilities is
ops/philox.py's mask, stream 0, at the row-major offset of each element of
the (B, ng, heads, nq, ctx) probabilities in the gathered-context layout
(`group_gather_indices`), keyed by the call's seed.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from simulst_tpu_torch.nn.core import masked_softmax
from simulst_tpu_torch.ops import _build
from simulst_tpu_torch.ops.mha import check_head_dim, padded_head_dim
from simulst_tpu_torch.ops.philox import drop_scale

MAX_ACC_FEATURES = 64  # kMaxAccFeatures: the dK / dV walks' features a pass
MIN_ACC_FEATURES = 16  # kMinAccFeatures: ... at the least
ROW_TILE, COL_TILE = 32, 64  # kRowTile, kColTile: a unit's padded tiles
SMEM_LIMIT = 227 * 1024      # shared memory one block may take on sm_90
MAX_STAGED_HEAD_DIM = 128    # kMaxHeadDim: the wide kernels above
# the bf16 backward on the tensor cores (csrc/emformer_attn_bwd.cu): the
# unit's padded columns it takes at most (kTcMaxCols), its rows a pass of
# the scores (kTcRows)
TC_MAX_COLS = 128
TC_ROWS = 32


def staged_head_dim(hd: int) -> int:
    """The kernels' staged head dim for head dim hd: 64 up to 64, else 128
    (features past hd are staged as zeros)."""
    return 64 if hd <= 64 else 128


class AttnGeom(NamedTuple):
    """Static geometry of the grouped attention."""
    U: int
    seg: int
    lc: int
    rc: int
    max_mem: int
    G: int
    num_heads: int

    @property
    def n(self):
        return self.U // self.seg

    @property
    def ng(self):
        return self.n // self.G

    @property
    def m_slots(self):
        return self.max_mem + self.G - 1

    @property
    def ctx(self):
        return self.m_slots + self.G * self.rc + self.lc + self.G * self.seg

    @property
    def nq(self):
        return self.G * (self.rc + self.seg + 1)

    @property
    def tk(self):
        return (self.n - 1) + self.n * self.rc + self.U


class EidGate(NamedTuple):
    """The sequence-packing gate: int32 example ids of the key rows, in the
    [mems | rc blocks | utterance] layout (nn/emformer.py `_build_kid`),
    and of the segments."""
    kid: torch.Tensor       # (B, Tk)
    seg_eid: torch.Tensor   # (B, n)


class UnitShape(NamedTuple):
    """The kernels' work unit: one segment of one (batch, group, head)."""
    rows: int      # the segment's query rows: rc + seg + 1
    cols: int      # the context slots they see at most: max_mem + rc + lc + seg
    fwd_smem: int  # shared-memory bytes of a forward block (one unit)
    bwd_smem: int  # ... of a backward block (the group's G units; one unit
                   # in the wide kernels)
    probs: int     # fp32 scratch of a backward block: G x 2 x rows x cols_pad
    acc_features: int  # features of the backward's dK / dV accumulators
                       # (0: the wide kernels hold none)


def unit_shape(geom: AttnGeom, head_dim: int) -> UnitShape:
    """The unit's rows and columns and the shared memory of a block, laid
    out as csrc/emformer_attn.cu `fwd_smem_bytes` / `bwd_smem_bytes`: Q
    (and dO) over the rows and K, V over the columns padded to whole
    tiles, rows of the staged head dim + 4 floats; one (two more in the
    backward) row-by-column matrix with a row stride of the padded columns
    + 4; three ints per column; the backward adds fp32 dK and dV
    accumulators of F features over the whole group context, F the
    largest of MAX_ACC_FEATURES, its half, ... down to MIN_ACC_FEATURES
    with which the block fits (`acc_features`).  Above
    MAX_STAGED_HEAD_DIM the wide kernels' blocks hold only the unit's
    matrices: one (the forward) or three (a backward unit block) and the
    three ints per column (csrc/emformer_attn.cu `wide_*_smem_bytes`)."""
    rows = geom.rc + geom.seg + 1
    cols = geom.max_mem + geom.rc + geom.lc + geom.seg
    rp = -(-rows // ROW_TILE) * ROW_TILE
    cp = -(-cols // COL_TILE) * COL_TILE
    if head_dim > MAX_STAGED_HEAD_DIM:
        matrix = rp * (cp + 4)
        return UnitShape(rows, cols, 4 * (matrix + 3 * cp),
                         4 * (3 * matrix + 3 * cp), 2 * geom.G * rows * cp,
                         0)
    shd = staged_head_dim(head_dim)
    ld = shd + 4
    tiles = rp * ld + 2 * cp * ld + rp * (cp + 4)

    def bwd(f):
        return 4 * (tiles + rp * ld + 2 * rp * (cp + 4) + 2 * geom.ctx * f
                    + 3 * cp)

    f = MAX_ACC_FEATURES
    while f > MIN_ACC_FEATURES and bwd(f) > SMEM_LIMIT:
        f //= 2
    return UnitShape(rows, cols, 4 * (tiles + 3 * cp), bwd(f),
                     2 * geom.G * rows * cp, f)


def _fitting_unit(name, geom: AttnGeom, head_dim: int,
                  backward: bool = False):
    """(unit_shape, the block's shared-memory bytes), raising where a block
    would need more shared memory than the card has."""
    unit = unit_shape(geom, head_dim)
    smem = unit.bwd_smem if backward else unit.fwd_smem
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{name}: {geom} at head dim {head_dim} needs {smem} bytes of "
            f"shared memory per block, above the {SMEM_LIMIT} a block may "
            f"take (the backward holds dK and dV of the group context's "
            f"{geom.ctx} slots, at least {MIN_ACC_FEATURES} features each)")
    return unit, smem


def tc_smem_bytes(geom: AttnGeom, head_dim: int) -> int:
    """Shared-memory bytes of a block of the bf16 backward on the tensor
    cores at head dim `head_dim` (a multiple of 8, at most 128), laid out
    as csrc/emformer_attn_bwd.cu `tc_smem_bytes`: two stages of Q and dO
    (the unit's rows padded to ROW_TILE) and K and V (its columns padded
    to COL_TILE), bf16 rows of the staged head dim + 8; dS and round(P m),
    bf16 rows of the padded columns + 8; the row statistics of a pass (4
    column quarters x TC_ROWS rows x 3 floats); fp32 dK and dV
    accumulators of the slots still open, the group's memory slots and a
    ring of lc + seg utterance slots, rows of the staged head dim + 8;
    two stages of four ints per column (slot, visibility, accumulator
    row, output)."""
    rp = _build.round_up(geom.rc + geom.seg + 1, ROW_TILE)
    cp = _build.round_up(geom.max_mem + geom.rc + geom.lc + geom.seg,
                         COL_TILE)
    ldh = staged_head_dim(head_dim) + 8
    open_slots = geom.m_slots + geom.lc + geom.seg
    return (2 * (2 * (2 * rp + 2 * cp) * ldh + 2 * rp * (cp + 8))
            + 4 * (4 * TC_ROWS * 3 + 2 * open_slots * ldh) + 4 * 2 * 4 * cp)


def bwd_plan(geom: AttnGeom, head_dim: int, dtype) -> str:
    """The backward's kernels on the card at head dim `head_dim` (as the
    kernels take it: a multiple of 8): "tensor_cores"
    (csrc/emformer_attn_bwd.cu) in bf16 up to head dim 128 where the
    unit's columns, padded to COL_TILE, are at most TC_MAX_COLS and its
    block fits (`tc_smem_bytes` at most SMEM_LIMIT); "units"
    (csrc/emformer_attn.cu's backward: fp32, head dims above 128, and the
    bf16 shapes beyond those) otherwise.  Either runs only on shapes
    `_fitting_unit` takes: those the units backward takes."""
    cols = geom.max_mem + geom.rc + geom.lc + geom.seg
    if dtype == torch.bfloat16 and head_dim <= MAX_STAGED_HEAD_DIM \
            and _build.round_up(cols, COL_TILE) <= TC_MAX_COLS \
            and tc_smem_bytes(geom, head_dim) <= SMEM_LIMIT:
        return "tensor_cores"
    return "units"


@functools.lru_cache(maxsize=64)
def group_row_seg(seg: int, rc: int, G: int) -> np.ndarray:
    """(nq,) map: grouped query row -> its segment within the group (rows
    are [G rc blocks | G segments | G summaries]); the JAX package's
    nn/emformer.py `_group_row_seg`."""
    nq = G * (rc + seg + 1)
    rows = np.arange(nq)
    return np.where(rows < G * rc, rows // rc,
                    np.where(rows < G * (rc + seg), (rows - G * rc) // seg,
                             rows - G * (rc + seg))).astype(np.int64)


@functools.lru_cache(maxsize=64)
def group_gather_indices(U: int, seg: int, lc: int, rc: int, max_mem: int,
                         G: int):
    """Static gather indices and per-row visibility for groups of G
    segments (nn/emformer.py `_group_gather_indices`).  Each group attends
    one union context [mems (max_mem+G-1 slots) | G rc blocks | lc + G*seg
    utterance window]; `allowed` (nq, ctx) keeps each query row to its own
    segment's slots.  Returns (idx (ng, ctx), valid (ng, ctx), utt_col
    (ng, ctx) frame index or -1, allowed (nq, ctx))."""
    n = U // seg
    ng = n // G
    mem_len = n - 1
    rc_len = n * rc
    m_slots = max_mem + G - 1
    ctx = m_slots + G * rc + lc + G * seg
    idx = np.zeros((ng, ctx), np.int64)
    valid = np.zeros((ng, ctx), bool)
    utt_col = np.full((ng, ctx), -1, np.int64)
    for g in range(ng):
        col = 0
        for t in range(m_slots):
            js = g * G - max_mem + t           # global segment-summary index
            idx[g, col] = max(min(js, mem_len - 1), 0)
            valid[g, col] = 0 <= js <= n - 2
            col += 1
        for j in range(G * rc):
            idx[g, col] = mem_len + g * G * rc + j
            valid[g, col] = True
            col += 1
        for j in range(lc + G * seg):
            u = g * G * seg - lc + j
            ok = 0 <= u < U
            idx[g, col] = mem_len + rc_len + (u if ok else 0)
            valid[g, col] = ok
            utt_col[g, col] = u if ok else -1
            col += 1
    nq = G * (rc + seg + 1)
    allowed = np.zeros((nq, ctx), bool)
    for r in range(nq):
        if r < G * rc:
            i, is_sum = r // rc, False
        elif r < G * (rc + seg):
            i, is_sum = (r - G * rc) // seg, False
        else:
            i, is_sum = r - G * (rc + seg), True
        if not is_sum:   # summary rows don't see the memory bank
            allowed[r, i:i + max_mem] = True
        allowed[r, m_slots + i * rc: m_slots + (i + 1) * rc] = True
        lo = m_slots + G * rc + i * seg
        allowed[r, lo: lo + lc + seg] = True
    return idx, valid, utt_col, allowed


def _context(q3, k, v, lengths, geom: AttnGeom,
             gate: Optional[EidGate] = None):
    """Per-head fp32 queries (B, ng, h, nq, hd), gathered keys and values
    (B, ng, h, ctx, hd), the visibility (B, ng, 1, nq, ctx) and the gather
    indices (ng, ctx)."""
    b, ng, nq, d = q3.shape
    h = geom.num_heads
    hd = d // h
    dev = q3.device
    idx, valid, utt_col, allowed = (torch.as_tensor(a, device=dev) for a in
                                    group_gather_indices(
                                        geom.U, geom.seg, geom.lc, geom.rc,
                                        geom.max_mem, geom.G))
    ctx = idx.shape[1]
    k_ctx = k.index_select(1, idx.reshape(-1)).reshape(b, ng, ctx, h, hd)
    v_ctx = v.index_select(1, idx.reshape(-1)).reshape(b, ng, ctx, h, hd)
    in_len = (utt_col[None] < lengths[:, None, None]) | (utt_col[None] < 0)
    key_valid = valid[None] & in_len                              # (B,ng,ctx)
    visible = key_valid[:, :, None, None, :] & allowed[None, None, None]
    if gate is not None:
        kid = gate.kid.long().index_select(1, idx.reshape(-1)).reshape(
            b, ng, ctx)
        rows = (torch.arange(ng, device=dev)[:, None] * geom.G
                + torch.as_tensor(group_row_seg(geom.seg, geom.rc, geom.G),
                                  device=dev)[None])
        qid = gate.seg_eid.long().index_select(1, rows.reshape(-1)).reshape(
            b, ng, nq)
        visible = visible & (kid[:, :, None, :] == qid[..., None])[:, :, None]
    qh = q3.float().reshape(b, ng, nq, h, hd).transpose(2, 3)
    return (qh, k_ctx.float().transpose(2, 3), v_ctx.float().transpose(2, 3),
            visible, idx)


def _probs(qh, kh, visible, rate, seed):
    """fp32 probabilities (B, ng, h, nq, ctx) and the dropout multiplier (or
    None at rate 0), offsets row-major over that shape."""
    scores = (qh @ kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5)
    p = masked_softmax(scores, visible)
    mult = drop_scale(seed, p.shape, rate, 0, p.device) if rate > 0.0 else None
    return p, mult


def max_visible_score(q3, k, v, lengths, geom: AttnGeom,
                      gate: Optional[EidGate] = None):
    """The largest pre-softmax score q . k / sqrt(hd) over the visible
    pairs (a 0-d fp32 tensor; -inf where nothing is visible), on the
    gathered context: what nn/emformer.py's score monitor records."""
    qh, kh, _, visible, _ = _context(q3, k, v, lengths, geom, gate)
    scores = (qh @ kh.transpose(-1, -2)) * (qh.shape[-1] ** -0.5)
    return scores.masked_fill(~visible, -float("inf")).max()


def _merge(x):
    """(B, ng, h, rows, hd) -> (B, ng, rows, h * hd)."""
    b, ng, h, rows, hd = x.shape
    return x.transpose(2, 3).reshape(b, ng, rows, h * hd)


def grouped_attention_plain(q3, k, v, lengths, geom: AttnGeom,
                            rate: float = 0.0, seed: int = 0,
                            gate: Optional[EidGate] = None):
    """Gather each group's context, mask, fp32 softmax, dropout, probs
    rounded to the activation dtype, then P @ V (the kernel's rounding
    points)."""
    qh, kh, vh, visible, _ = _context(q3, k, v, lengths, geom, gate)
    p, mult = _probs(qh, kh, visible, rate, seed)
    pd = (p if mult is None else p * mult).to(q3.dtype).float()
    return _merge(pd @ vh).to(q3.dtype)


def grouped_attention_plain_backward(q3, k, v, lengths, dout, geom: AttnGeom,
                                     rate: float = 0.0, seed: int = 0,
                                     gate: Optional[EidGate] = None):
    """(dq, dk, dv) with the probabilities and the mask recomputed, as
    emformer_attn_pallas._bwd_kernel; dk and dv are the context gradients
    summed into their key rows in fp32."""
    dtype = q3.dtype
    b, ng, nq, d = q3.shape
    qh, kh, vh, visible, idx = _context(q3, k, v, lengths, geom, gate)
    p, mult = _probs(qh, kh, visible, rate, seed)
    pd = (p if mult is None else p * mult).to(dtype).float()
    do = dout.float().reshape(b, ng, nq, geom.num_heads, -1).transpose(2, 3)
    dv_ctx = pd.transpose(-1, -2) @ do
    dp = do @ vh.transpose(-1, -2)
    if mult is not None:
        dp = dp * mult
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * (qh.shape[-1] ** -0.5)).to(dtype).float()
    dq = _merge(ds @ kh).to(dtype)
    dk_ctx = ds.transpose(-1, -2) @ qh

    def to_rows(g_ctx):
        rows = torch.zeros(b, k.shape[1], d, dtype=torch.float32,
                           device=q3.device)
        rows.index_add_(1, idx.reshape(-1), _merge(g_ctx).reshape(b, -1, d))
        return rows.to(dtype)

    return dq, to_rows(dk_ctx), to_rows(dv_ctx)


def _check(name, q3, k, v, lengths, geom: AttnGeom):
    """The head dim, after raising unless the kernels take these inputs."""
    b, ng, nq, d = q3.shape
    if (ng, nq) != (geom.ng, geom.nq) or geom.rc <= 0 \
            or k.shape != (b, geom.tk, d) or v.shape != k.shape \
            or lengths.shape != (b,):
        raise ValueError(
            f"{name}: kernel takes rc > 0 and exact shapes; got q3 "
            f"{tuple(q3.shape)}, k {tuple(k.shape)}, lengths "
            f"{tuple(lengths.shape)} for {geom}")
    hd = check_head_dim(name, d, geom.num_heads)
    if lengths.dtype != torch.int32 or lengths.device != q3.device:
        raise TypeError(f"{name}: lengths must be an int32 tensor on "
                        f"{q3.device}")
    return hd


def _check_gate(name, q3, gate: Optional[EidGate], geom: AttnGeom):
    """Raise unless `gate` is None or two int32 tensors on q3's device of
    shapes (B, Tk) and (B, n)."""
    if gate is None:
        return
    b = q3.shape[0]
    kid, seg_eid = gate
    for key, t, shape in (("kid", kid, (b, geom.tk)),
                          ("seg_eid", seg_eid, (b, geom.n))):
        if not isinstance(t, torch.Tensor) or t.shape != shape \
                or t.dtype != torch.int32 or t.device != q3.device:
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}"
                   if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"{name}: gate.{key} must be an int32 tensor "
                             f"{shape} on {q3.device}, got {got}")


def _geom_args(q3, geom: AttnGeom, hd: int, unit: UnitShape, smem: int):
    """The C entries' geometry arguments for q3 padded to its kernels'
    head dim, hd the real one."""
    b, ng, nq, d = q3.shape
    return (b, ng, nq, d, geom.num_heads, hd, geom.seg, geom.lc, geom.rc,
            geom.max_mem, geom.G, geom.tk, unit.cols, smem)


def _gate_ptrs(gate: Optional[EidGate]):
    """The gate's two pointers for the C entries, (None, None) without one
    (the ungated kernels)."""
    if gate is None:
        return None, None
    return tuple(t.contiguous().data_ptr() for t in gate)


def _count(wrapper, gate):
    """One launch on the wrapper's counter for the dense or the gated
    kernels."""
    if gate is None:
        wrapper.launches += 1
    else:
        wrapper.gated_launches += 1


def _launch(q3, k, v, lengths, geom: AttnGeom, rate, seed, gate=None):
    hd = _check("emformer_grouped_attention", q3, k, v, lengths, geom)
    hdp = padded_head_dim(hd)
    unit, smem = _fitting_unit("emformer_grouped_attention", geom, hdp)
    q3, k, v, lengths = (t.contiguous() for t in (q3, k, v, lengths))
    _build.check_cuda("emformer_grouped_attention", q3, k=k, v=v)
    q3, k, v = (_build.padded_groups(t, geom.num_heads, hdp)
                for t in (q3, k, v))
    out = torch.empty_like(q3)
    _build.launch("simulst_emformer_attn", _build.dtype_code(q3),
                  q3.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), *_gate_ptrs(gate), out.data_ptr(),
                  *_geom_args(q3, geom, hd, unit, smem),
                  *_build.dropout_args(rate, seed),
                  _build.stream_of(q3))
    _count(emformer_grouped_attention, gate)
    return _build.unpadded_groups(out, geom.num_heads, hd)


def _launch_backward(q3, k, v, lengths, dout, geom: AttnGeom, rate, seed,
                     gate=None):
    name = "emformer_grouped_attention_backward"
    hd = _check(name, q3, k, v, lengths, geom)
    hdp = padded_head_dim(hd)
    unit, smem = _fitting_unit(name, geom, hdp, backward=True)
    q3, k, v, lengths, dout = (t.contiguous() for t in
                               (q3, k, v, lengths, dout))
    _build.check_cuda(name, q3, k=k, v=v, dout=dout)
    q3, k, v, dout = (_build.padded_groups(t, geom.num_heads, hdp)
                      for t in (q3, k, v, dout))
    b, ng, nq, d = q3.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k, v))
    f32 = dict(dtype=torch.float32, device=q3.device)
    dk_part, dv_part = (torch.empty(b, ng, geom.ctx, d, **f32)
                        for _ in range(2))
    ptrs = (q3.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            *_gate_ptrs(gate), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    tail = (*_build.dropout_args(rate, seed), _build.stream_of(q3))
    if bwd_plan(geom, hdp, q3.dtype) == "tensor_cores":
        _build.launch("simulst_emformer_attn_bwd_tc", *ptrs,
                      dk_part.data_ptr(), dv_part.data_ptr(),
                      *_geom_args(q3, geom, hd, unit,
                                  tc_smem_bytes(geom, hdp)), *tail)
    else:
        probs = torch.empty(b * ng * geom.num_heads * unit.probs, **f32)
        _build.launch("simulst_emformer_attn_bwd", _build.dtype_code(q3),
                      *ptrs, probs.data_ptr(), dk_part.data_ptr(),
                      dv_part.data_ptr(),
                      *_geom_args(q3, geom, hd, unit, smem), *tail)
    _count(emformer_grouped_attention_backward, gate)
    return tuple(_build.unpadded_groups(t, geom.num_heads, hd)
                 for t in (dq, dk, dv))


def emformer_grouped_attention_forward(q3, k, v, lengths, geom: AttnGeom,
                                       rate: float = 0.0, seed: int = 0,
                                       gate: Optional[EidGate] = None):
    """The output without autograd: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    _check_gate("emformer_grouped_attention", q3, gate, geom)
    if q3.device.type == "cpu":
        return grouped_attention_plain(q3, k, v, lengths, geom, rate, seed,
                                       gate)
    return _launch(q3, k, v, lengths, geom, rate, seed, gate)


def emformer_grouped_attention_backward(q3, k, v, lengths, dout,
                                        geom: AttnGeom, rate: float = 0.0,
                                        seed: int = 0,
                                        gate: Optional[EidGate] = None):
    """(dq, dk, dv) for upstream gradient dout: the CUDA kernels on a CUDA
    tensor, the plain version on a CPU tensor."""
    _check_gate("emformer_grouped_attention_backward", q3, gate, geom)
    if q3.device.type == "cpu":
        return grouped_attention_plain_backward(q3, k, v, lengths, dout, geom,
                                                rate, seed, gate)
    return _launch_backward(q3, k, v, lengths, dout, geom, rate, seed, gate)


class _GroupedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q3, k, v, lengths, geom, rate, seed, gate):
        ctx.save_for_backward(q3, k, v, lengths,
                              *(() if gate is None else gate))
        ctx.config = (geom, rate, seed)
        return emformer_grouped_attention_forward(q3, k, v, lengths, geom,
                                                  rate, seed, gate)

    @staticmethod
    def backward(ctx, dout):
        q3, k, v, lengths, *gate = ctx.saved_tensors
        dq, dk, dv = emformer_grouped_attention_backward(
            q3, k, v, lengths, dout, *ctx.config,
            EidGate(*gate) if gate else None)
        return dq, dk, dv, None, None, None, None, None


def emformer_grouped_attention(q3, k, v, lengths, geom: AttnGeom,
                               rate: float = 0.0, seed: int = 0,
                               gate: Optional[EidGate] = None):
    """Differentiable in q3, k and v (the backward is
    `emformer_grouped_attention_backward`); seed keys the dropout mask on
    the probabilities (ignored at rate 0); `gate` adds the example-id rule
    of sequence-packed rows (no gradient flows to the ids).  Launches count
    on `.launches`, those of the gated kernels on `.gated_launches`."""
    if not _build.needs_grad(q3, k, v):
        return emformer_grouped_attention_forward(q3, k, v, lengths, geom,
                                                  rate, seed, gate)
    return _GroupedAttention.apply(q3, k, v, lengths, geom, rate, seed, gate)


emformer_grouped_attention.launches = 0
emformer_grouped_attention.gated_launches = 0
emformer_grouped_attention_backward.launches = 0
emformer_grouped_attention_backward.gated_launches = 0
