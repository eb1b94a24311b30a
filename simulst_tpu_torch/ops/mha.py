"""Fused multi-head attention core (counterpart of
simulst_tpu/ops/mha_pallas.py `fused_mha`, forward and backward).

The attention after the q/k/v projections and before out_proj:
qp (B, Tq, D), kp / vp (B, Tk, D), heads are column slices of D;
kmask (B, Tk) int32, nonzero where the key may be attended; `causal` adds
key <= query; dropout at `rate` on the probabilities.  Returns the merged
(B, Tq, D) output.  On a CUDA tensor the CUDA kernels of csrc/mha.cu run
(any head dim D / heads, `check_head_dim`, and any Tq and Tk; a head dim
that is not a multiple of 8 reaches them with each head zero-padded to
the next one, the real head dim beside it for the scale, and the outputs
are sliced back; up to head dim 128 the forward on one of two kernels
that give the same bits, as `fwd_plan` picks by Tq, above it the wide
kernels, correct rather than fast); on a CPU tensor
`mha_plain` and `mha_plain_backward`.  The softmax is the running-max form in fp32; a
query row that sees no key returns exact zeros, as the JAX kernel's -1e9
bias with its 1e-30 denominator does.  Probabilities are rounded to the
activation dtype before the product with v, as in the JAX kernel.  The
dropout mask is ops/philox.py's, stream 0 at offset ((b H + h) Tq + q) Tk
+ k, keyed by the call's seed.  The plain backward mirrors the JAX
`_bwd_kernel` formulas, not autograd.
"""
from __future__ import annotations

import torch

from simulst_tpu_torch.nn.core import masked_softmax
from simulst_tpu_torch.ops import _build
from simulst_tpu_torch.ops.philox import drop_scale

HEAD_DIM_STEP = 8    # the kernels' head dim: a multiple of it (csrc/mha.cu
                     # kHDStep); others are padded
MAX_HEAD_DIM = 128   # the tiled kernels' (kMaxHD); the wide kernels above
KEY_TILE = 64    # csrc/mha.cu kTile: the dS scratch's rows are whole tiles
# the forward runs the decode kernel (up to 2 query rows of a head per
# block) up to this many query rows, the training kernel (64-row q tiles)
# above: both give the same bits (H100 times in PERF.md, from
# tools/kernel_bitcheck.py --time)
DECODE_MAX_TQ = 2
FWD_PATHS = {"decode": 0, "tiles": 1}   # csrc/mha.cu kPathDecode, ...


def fwd_plan(tq: int) -> str:
    """The forward's kernel at tq query rows: "decode" up to
    DECODE_MAX_TQ, "tiles" above."""
    return "decode" if tq <= DECODE_MAX_TQ else "tiles"


def _heads(x, num_heads):
    b, t, d = x.shape
    return x.float().reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge(x):
    b, h, t, hd = x.shape
    return x.transpose(1, 2).reshape(b, t, h * hd)


def _visible(kmask, tq, causal):
    """(B, 1, Tq, Tk) bool."""
    vis = (kmask != 0)[:, None, None, :]
    if causal:
        tk = kmask.shape[1]
        q = torch.arange(tq, device=kmask.device)[:, None]
        k = torch.arange(tk, device=kmask.device)[None, :]
        vis = vis & (k <= q)
    return vis


def _probs(qp, kp, kmask, num_heads, causal, rate, seed):
    """fp32 probabilities p (B, H, Tq, Tk) and the dropout multiplier
    (or None at rate 0)."""
    hd = qp.shape[-1] // num_heads
    s = (_heads(qp, num_heads) @ _heads(kp, num_heads).transpose(-1, -2)) \
        * (hd ** -0.5)
    p = masked_softmax(s, _visible(kmask, qp.shape[1], causal))
    mult = drop_scale(seed, p.shape, rate, 0, qp.device) if rate > 0.0 else None
    return p, mult


def mha_plain(qp, kp, vp, kmask, num_heads: int, causal: bool = False,
              rate: float = 0.0, seed: int = 0):
    p, mult = _probs(qp, kp, kmask, num_heads, causal, rate, seed)
    pd = p if mult is None else p * mult
    out = pd.to(qp.dtype).float() @ _heads(vp, num_heads)
    return _merge(out).to(qp.dtype)


def mha_plain_backward(qp, kp, vp, kmask, dout, num_heads: int,
                       causal: bool = False, rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) with the probabilities recomputed, as
    mha_pallas._bwd_kernel."""
    dtype = qp.dtype
    hd = qp.shape[-1] // num_heads
    p, mult = _probs(qp, kp, kmask, num_heads, causal, rate, seed)
    pd = (p if mult is None else p * mult).to(dtype).float()
    do = _heads(dout, num_heads)
    dv = pd.transpose(-1, -2) @ do
    dp = do @ _heads(vp, num_heads).transpose(-1, -2)
    if mult is not None:
        dp = dp * mult
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * (hd ** -0.5)).to(dtype).float()
    dq = ds @ _heads(kp, num_heads)
    dk = ds.transpose(-1, -2) @ _heads(qp, num_heads)
    return tuple(_merge(t).to(dtype) for t in (dq, dk, dv))


def check_head_dim(name: str, d: int, num_heads: int) -> int:
    """The head dim D / num_heads; a ValueError naming it unless the
    kernels take it (a positive head dim, D a whole number of heads)."""
    hd = d // num_heads if num_heads > 0 else 0
    if num_heads <= 0 or hd * num_heads != d or hd < 1:
        raise ValueError(
            f"{name}: kernel takes a positive head dim, D a whole number of "
            f"heads; got D {d} over {num_heads} heads")
    return hd


def padded_head_dim(hd: int) -> int:
    """The head dim the kernels take for head dim hd: the next multiple of
    HEAD_DIM_STEP (its 16-byte loads of fp32 and bf16 rows)."""
    return _build.round_up(hd, HEAD_DIM_STEP)


def _check(name, qp, kp, vp, kmask, num_heads):
    b, tq, d = qp.shape
    if kp.ndim != 3 or kp.shape[0] != b or kp.shape[2] != d or \
            vp.shape != kp.shape or kmask.shape != kp.shape[:2]:
        raise ValueError(
            f"{name}: kernel takes qp (B, Tq, D), kp = vp (B, Tk, D), kmask "
            f"(B, Tk); got qp {tuple(qp.shape)}, kp {tuple(kp.shape)}, vp "
            f"{tuple(vp.shape)}, kmask {tuple(kmask.shape)}")
    hd = check_head_dim(name, d, num_heads)
    if kmask.dtype != torch.int32 or kmask.device != qp.device:
        raise TypeError(f"{name}: kmask must be an int32 tensor on {qp.device}")
    return hd


def _check_lse(lse, qp, num_heads):
    b, tq, _ = qp.shape
    if lse is None or lse.shape != (b, num_heads, tq) or \
            lse.dtype != torch.float32 or lse.device != qp.device or \
            not lse.is_contiguous():
        raise ValueError("fused_mha_backward: lse must be the forward's "
                         f"contiguous fp32 (B, H, Tq) = {(b, num_heads, tq)} "
                         f"tensor on {qp.device}")


def backward_scratch_shapes(b: int, num_heads: int, tq: int, tk: int,
                            hd: int = 0):
    """Shapes of the backward kernels' fp32 scratch: delta = dO . O per
    query row (B, H, Tq), and dS (B, H, Tq, Tk rounded up to KEY_TILE),
    which the dK / dV kernel writes and the dQ kernel reads; above head
    dim MAX_HEAD_DIM twice that (the wide kernels' dS and dropped
    probabilities)."""
    ds = (b, num_heads, tq, -(-tk // KEY_TILE) * KEY_TILE)
    return ((b, num_heads, tq), (2, *ds) if hd > MAX_HEAD_DIM else ds)


def _launch(qp, kp, vp, kmask, num_heads, causal, rate, seed):
    hd = _check("fused_mha", qp, kp, vp, kmask, num_heads)
    qp, kp, vp, kmask = (t.contiguous() for t in (qp, kp, vp, kmask))
    _build.check_cuda("fused_mha", qp, kp=kp, vp=vp)
    hdp = padded_head_dim(hd)
    qp, kp, vp = (_build.padded_groups(t, num_heads, hdp)
                  for t in (qp, kp, vp))
    # the kernels' 16-byte tile loads
    qp, kp, vp = (_build.aligned(t) for t in (qp, kp, vp))
    b, tq, d = qp.shape
    tk = kp.shape[1]
    out = torch.empty_like(qp)
    lse = torch.empty(b, num_heads, tq, dtype=torch.float32, device=qp.device)
    if b and tq and tk:
        on, seed64, thr, inv = _build.dropout_args(rate, seed)
        _build.launch("simulst_mha_fwd", _build.dtype_code(qp), qp.data_ptr(),
                      kp.data_ptr(), vp.data_ptr(), kmask.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), b, tq, tk, d, num_heads,
                      hd, int(causal), FWD_PATHS[fwd_plan(tq)], on, seed64,
                      thr, inv, _build.stream_of(qp))
        fused_mha.launches += 1
    else:
        out.zero_()
    return _build.unpadded_groups(out, num_heads, hd), lse


def _launch_backward(qp, kp, vp, kmask, out, lse, dout, num_heads, causal,
                     rate, seed):
    hd = _check("fused_mha_backward", qp, kp, vp, kmask, num_heads)
    _check_lse(lse, qp, num_heads)
    qp, kp, vp, kmask, out, dout = (t.contiguous() for t in
                                    (qp, kp, vp, kmask, out, dout))
    _build.check_cuda("fused_mha_backward", qp, kp=kp, vp=vp, out=out,
                      dout=dout)
    hdp = padded_head_dim(hd)
    qp, kp, vp, out, dout = (_build.padded_groups(t, num_heads, hdp)
                             for t in (qp, kp, vp, out, dout))
    # the kernels' 16-byte tile loads
    qp, kp, vp, dout = (_build.aligned(t) for t in (qp, kp, vp, dout))
    b, tq, d = qp.shape
    tk = kp.shape[1]
    # the kernels write each entry
    alloc = torch.empty_like if b and tq and tk else torch.zeros_like
    dq, dk, dv = (alloc(t) for t in (qp, kp, vp))
    if b and tq and tk:
        on, seed64, thr, inv = _build.dropout_args(rate, seed)
        delta, ds = (torch.empty(shape, dtype=torch.float32, device=qp.device)
                     for shape in backward_scratch_shapes(b, num_heads, tq,
                                                          tk, hdp))
        _build.launch("simulst_mha_bwd", _build.dtype_code(qp), qp.data_ptr(),
                      kp.data_ptr(), vp.data_ptr(), kmask.data_ptr(),
                      out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                      delta.data_ptr(), ds.data_ptr(), b, tq, tk, d,
                      num_heads, hd, int(causal), on, seed64, thr, inv,
                      _build.stream_of(qp))
        fused_mha_backward.launches += 1
    return tuple(_build.unpadded_groups(t, num_heads, hd)
                 for t in (dq, dk, dv))


def fused_mha_backward(qp, kp, vp, kmask, out, lse, dout, num_heads: int,
                       causal: bool = False, rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of fused_mha for upstream gradient dout.  The CUDA
    kernels take the forward's output and per-row log-sum-exp `lse`
    (B, H, Tq); the plain version (CPU) recomputes from the inputs."""
    if qp.device.type == "cpu":
        return mha_plain_backward(qp, kp, vp, kmask, dout, num_heads, causal,
                                  rate, seed)
    return _launch_backward(qp, kp, vp, kmask, out, lse, dout, num_heads,
                            causal, rate, seed)


def fused_mha_forward(qp, kp, vp, kmask, num_heads: int, causal: bool = False,
                      rate: float = 0.0, seed: int = 0):
    """(out, lse): the output and, on the card, the (B, H, Tq) fp32 per-row
    log-sum-exp the backward kernels take (None on the CPU)."""
    if qp.device.type == "cpu":
        return mha_plain(qp, kp, vp, kmask, num_heads, causal, rate, seed), None
    return _launch(qp, kp, vp, kmask, num_heads, causal, rate, seed)


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qp, kp, vp, kmask, num_heads, causal, rate, seed):
        out, lse = fused_mha_forward(qp, kp, vp, kmask, num_heads, causal,
                                     rate, seed)
        ctx.save_for_backward(qp, kp, vp, kmask, out, lse)
        ctx.config = (num_heads, causal, rate, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        qp, kp, vp, kmask, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_mha_backward(qp, kp, vp, kmask, out, lse, dout,
                                        *ctx.config)
        return dq, dk, dv, None, None, None, None, None


def fused_mha(qp, kp, vp, kmask, num_heads: int, causal: bool = False,
              rate: float = 0.0, seed: int = 0):
    """Fused attention core; differentiable in qp, kp and vp (the backward is
    `fused_mha_backward`).  seed keys the dropout mask (ignored at rate 0)."""
    if not _build.needs_grad(qp, kp, vp):
        return fused_mha_forward(qp, kp, vp, kmask, num_heads, causal, rate,
                                 seed)[0]
    return _FusedMHA.apply(qp, kp, vp, kmask, num_heads, causal, rate, seed)


fused_mha.launches = 0
fused_mha_backward.launches = 0
