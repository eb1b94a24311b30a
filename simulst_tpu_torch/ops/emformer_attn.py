"""Grouped-segment Emformer attention core (counterpart of
simulst_tpu/ops/emformer_attn_pallas.py `emformer_grouped_attention`,
forward at dropout 0, without the sequence-packing id gate).

q3: (B, ng, nq, D) projected queries, rows [G rc blocks | G segments |
G summaries] per group; k/v: (B, Tk, D) projected rows of [mems (n-1) |
rc blocks (n*rc) | utterance (U)] at their exact Tk; lengths (B,) int32.
Returns (B, ng, nq, D), before out_proj.  On a CUDA tensor the kernel
csrc/emformer_attn.cu runs, forward only: its backward kernel is ROADMAP
Queue 2, and autograd reaching the kernel's output raises.  On a CPU tensor
`grouped_attention_plain`, the gathered-context formulation of
nn/emformer.py `_grouped_attention`.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from simulst_tpu_torch.nn.core import masked_softmax
from simulst_tpu_torch.ops import _build

HEAD_DIM = 64            # csrc/emformer_attn.cu kHeadDim
MAX_ROWS_PER_BLOCK = 64  # query rows one block takes (grid.y splits nq)


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


def grouped_attention_plain(q3, k, v, lengths, geom: AttnGeom):
    """Gather each group's context, mask, fp32 softmax, probs rounded to the
    activation dtype, then P @ V (the kernel's rounding points)."""
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
    qh = q3.float().reshape(b, ng, nq, h, hd).transpose(2, 3)     # (B,ng,h,nq,hd)
    kh = k_ctx.float().permute(0, 1, 3, 4, 2)                     # (B,ng,h,hd,ctx)
    vh = v_ctx.float().transpose(2, 3)                            # (B,ng,h,ctx,hd)
    scores = (qh @ kh) * (hd ** -0.5)
    probs = masked_softmax(scores, visible).to(q3.dtype).float()
    out = (probs @ vh).transpose(2, 3).reshape(b, ng, nq, d)
    return out.to(q3.dtype)


def emformer_grouped_attention(q3, k, v, lengths, geom: AttnGeom):
    if q3.device.type == "cpu":
        return grouped_attention_plain(q3, k, v, lengths, geom)
    return _build.forward_only("emformer_grouped_attention", _launch, q3, k, v,
                               lengths, geom)


def _launch(q3, k, v, lengths, geom: AttnGeom):
    b, ng, nq, d = q3.shape
    if (ng, nq) != (geom.ng, geom.nq) or d != geom.num_heads * HEAD_DIM \
            or geom.rc <= 0 or k.shape != (b, geom.tk, d) \
            or v.shape != k.shape or lengths.shape != (b,):
        raise ValueError(
            f"emformer_grouped_attention: kernel takes head dim {HEAD_DIM}, "
            f"rc > 0 and exact shapes; got q3 {tuple(q3.shape)}, k "
            f"{tuple(k.shape)}, lengths {tuple(lengths.shape)} for {geom}")
    if lengths.dtype != torch.int32 or lengths.device != q3.device:
        raise TypeError("emformer_grouped_attention: lengths must be an int32 "
                        f"tensor on {q3.device}")
    q3, k, v = q3.contiguous(), k.contiguous(), v.contiguous()
    lengths = lengths.contiguous()
    _build.check_cuda("emformer_grouped_attention", q3, k=k, v=v)
    out = torch.empty_like(q3)
    chunks = -(-nq // MAX_ROWS_PER_BLOCK)
    _build.launch("simulst_emformer_attn", _build.dtype_code(q3),
                  q3.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), b, ng, nq, d,
                  geom.num_heads, geom.seg, geom.lc, geom.rc, geom.max_mem,
                  geom.G, geom.tk, -(-nq // chunks), _build.stream_of(q3))
    emformer_grouped_attention.launches += 1
    return out


emformer_grouped_attention.launches = 0
