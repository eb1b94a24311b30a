"""Fused projection + dropout + gated residual (counterpart of
simulst_tpu/ops/linear_res_pallas.py `fused_linear_drop_res`, forward and
backward).

    y = res + drop(h @ w + b)   on rows with row % period < res_rows
    y = h @ w + b               on the others (they ignore `res`)

Rows are counted in the flattened row-major order of h's leading axes;
period = 0 makes every row a residual row.  On a CUDA tensor the CUDA
kernels of csrc/linear_res.cu run (the forward on one of two paths that
give the same bits, as `fwd_plan` picks by row count) at any positive D_in
and D_out (`check_widths`; a D_in not a multiple of 32 or a D_out not a
multiple of 64 reaches them zero-padded to the next one, the real D_out
beside it for the dropout offsets, and the output is sliced back); on a
CPU tensor
`linear_res_plain` and `linear_res_plain_backward`.  In bf16 the
backward's two products and the forward's product on its tiled paths
(`fwd_uses_tensor_cores`) run on the tensor cores (csrc/wgmma.cuh), du a
bf16 buffer, so kernel and plain version agree within bf16 tolerance.  w keeps the JAX layout (D_in, D_out).  The
dropout mask is ops/philox.py's, stream 0 at offset row * D_out + column,
keyed by the call's seed; d(res) is the upstream gradient on residual rows
and zero elsewhere, as in the JAX package's _flr_bwd.
"""
from __future__ import annotations

import torch

from simulst_tpu_torch.ops import _build
from simulst_tpu_torch.ops.ffn import WGRAD_TILE, k_splits
from simulst_tpu_torch.ops.philox import drop_scale

K_STEP = 32      # csrc/linear_res.cu kBK: the kernels' D_in a multiple
COL_TILE = 64    # csrc/linear_res.cu kBN: the kernels' D_out a multiple
# the forward's paths, which give the same bits: the row kernel (8 rows x
# 32 columns per block) below TILED_MIN_ROWS, tile_product with 128 x 64
# output tiles from it, with 128 x 128 tiles from WIDE_MIN_ROWS (H100
# times in PERF.md, from tools/kernel_bitcheck.py --time)
TILED_MIN_ROWS = 1536
WIDE_MIN_ROWS = 8192
FWD_PATHS = {"rows": 0, "tiled": 1, "wide": 2}   # csrc/linear_res.cu kPath*


def _residual_rows(n: int, period: int, res_rows: int, device):
    rows = torch.arange(n, device=device)
    if period == 0:
        return torch.ones(n, dtype=torch.bool, device=device)
    return rows % period < res_rows


def _grad_scale(n, dout, period, res_rows, rate, seed, device):
    """(rows, D_out) fp32 multiplier of the projection: the dropout mask on
    residual rows, 1 on plain rows; and the (rows,) residual-row flags."""
    gate = _residual_rows(n, period, res_rows, device)
    if rate > 0.0:
        drop = drop_scale(seed, (n, dout), rate, 0, device)
        return torch.where(gate[:, None], drop, 1.0), gate
    return torch.ones(n, 1, device=device), gate


def linear_res_plain(h, w, b, res, period: int = 0, res_rows: int = 0,
                     rate: float = 0.0, seed: int = 0):
    din, dout = w.shape
    h2 = h.reshape(-1, din)
    u = h2.float() @ w.float() + b.float()
    scale, gate = _grad_scale(h2.shape[0], dout, period, res_rows, rate, seed,
                              h.device)
    y = torch.where(gate[:, None], u * scale + res.reshape(-1, dout).float(), u)
    return y.to(h.dtype).reshape(*h.shape[:-1], dout)


def linear_res_plain_backward(h, w, dy, period: int = 0, res_rows: int = 0,
                              rate: float = 0.0, seed: int = 0):
    """(dh, dw, db) of linear_res_plain, dw and db in fp32, as
    linear_res_pallas._bwd_kernel."""
    din, dout = w.shape
    h2 = h.reshape(-1, din)
    dy2 = dy.reshape(-1, dout)
    scale, _ = _grad_scale(h2.shape[0], dout, period, res_rows, rate, seed,
                           h.device)
    du = (dy2.float() * scale).to(h.dtype).float()
    dh = (du @ w.float().T).to(h.dtype).reshape(h.shape)
    return dh, h2.float().T @ du, du.sum(0)


def fwd_plan(rows: int) -> str:
    """The forward's path at `rows` rows: "rows" (the row kernel) below
    TILED_MIN_ROWS, "tiled" from it, "wide" from WIDE_MIN_ROWS."""
    if rows >= WIDE_MIN_ROWS:
        return "wide"
    return "tiled" if rows >= TILED_MIN_ROWS else "rows"


def fwd_uses_tensor_cores(path: str, dtype) -> bool:
    """Whether the forward's `path` runs its product on the tensor cores:
    both tiled paths in bf16 (csrc/wgmma.cuh's wgmma_product into an fp32
    scratch of rows x D_out, then the epilogue as a pass of its own); the
    row kernel, and fp32 on every path, on the CUDA cores."""
    return dtype == torch.bfloat16 and path != "rows"


def check_widths(name: str, din: int, dout: int) -> None:
    """Raise a ValueError naming the widths unless the kernels take them:
    a positive D_in and D_out."""
    if din < 1 or dout < 1:
        raise ValueError(f"{name}: kernel takes a positive D_in and D_out; "
                         f"got D_in={din}, D_out={dout}")


def _check(name, h, w, res=None, period=0):
    din, dout = w.shape
    if h.shape[-1] != din or period < 0 \
            or (res is not None and res.shape != (*h.shape[:-1], dout)):
        raise ValueError(
            f"{name}: kernel takes h (..., D_in), w (D_in, D_out), res "
            f"(..., D_out) and period >= 0; got h {tuple(h.shape)}, w "
            f"{tuple(w.shape)}, res "
            f"{None if res is None else tuple(res.shape)}, period {period}")
    check_widths(name, din, dout)
    return din, dout


def padded_widths(din: int, dout: int):
    """(D_in, D_out) as the kernels take them: rounded up to multiples of
    K_STEP and COL_TILE; the call pads to them with zeros."""
    return _build.round_up(din, K_STEP), _build.round_up(dout, COL_TILE)


def _launch(h, w, b, res, period, res_rows, rate, seed):
    din_real, dout_real = _check("fused_linear_res", h, w, res, period)
    h2 = h.reshape(-1, din_real).contiguous()
    res2 = res.reshape(-1, dout_real).contiguous()
    _build.check_cuda("fused_linear_res", h2, w=w, b=b, res=res2)
    din, dout = padded_widths(din_real, dout_real)
    h2, res2 = _build.padded(h2, din), _build.padded(res2, dout)
    w, b = _build.padded(w, din, dout), _build.padded(b, dout)
    h2, w = _build.aligned(h2), _build.aligned(w)   # the 16-byte loads
    n = h2.shape[0]
    y = torch.empty(n, dout, dtype=h.dtype, device=h.device)
    if n:
        path = fwd_plan(n)
        # the bf16 tiled paths' product, before its epilogue pass
        u = torch.empty(n, dout, dtype=torch.float32, device=h.device) \
            if fwd_uses_tensor_cores(path, h2.dtype) else None
        on, seed64, thr, inv = _build.dropout_args(rate, seed)
        _build.launch("simulst_linear_res", _build.dtype_code(h2),
                      h2.data_ptr(), w.data_ptr(), b.data_ptr(),
                      res2.data_ptr(), y.data_ptr(),
                      None if u is None else u.data_ptr(), n, din, dout,
                      dout_real, period, res_rows, FWD_PATHS[path], on,
                      seed64, thr, inv, _build.stream_of(h2))
        fused_linear_res.launches += 1
    return _build.unpadded(y, dout_real).reshape(*h.shape[:-1], dout_real)


def _launch_backward(h, w, dy, period, res_rows, rate, seed):
    din_real, dout_real = _check("fused_linear_res_backward", h, w,
                                 period=period)
    h2 = h.reshape(-1, din_real).contiguous()
    dy2 = dy.reshape(-1, dout_real).contiguous()
    _build.check_cuda("fused_linear_res_backward", h2, w=w, dy=dy2)
    din, dout = padded_widths(din_real, dout_real)
    h2, dy2 = _build.padded(h2, din), _build.padded(dy2, dout)
    w = _build.padded(w, din, dout)
    h2, w = _build.aligned(h2), _build.aligned(w)   # the products' operands
    n = h2.shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    length = din * dout + dout
    alloc = torch.empty if n else torch.zeros   # the kernels write each entry
    grads = alloc(length, **f32)
    dh = alloc(h2.shape, dtype=h2.dtype, device=h.device)
    if n:
        tiles = -(-din // WGRAD_TILE) * -(-dout // WGRAD_TILE)
        splits = k_splits(n, tiles, h.device)
        # du of the activation dtype (bf16: both products on the tensor
        # cores)
        du = torch.empty(n, dout, dtype=h2.dtype, device=h.device)
        partial = torch.zeros(splits, length, **f32)
        on, seed64, thr, inv = _build.dropout_args(rate, seed)
        _build.launch("simulst_linear_res_bwd", _build.dtype_code(h2),
                      h2.data_ptr(), w.data_ptr(), dy2.data_ptr(),
                      dh.data_ptr(), grads.data_ptr(), du.data_ptr(),
                      partial.data_ptr(), n, din, dout, dout_real, period,
                      res_rows, splits, on, seed64, thr, inv,
                      _build.stream_of(h2))
        fused_linear_res_backward.launches += 1
    return (_build.unpadded(dh, din_real).reshape(h.shape),
            _build.unpadded(grads[:din * dout].view(din, dout), din_real,
                            dout_real),
            grads[din * dout:din * dout + dout_real])


def fused_linear_res_forward(h, w, b, res, period: int = 0, res_rows: int = 0,
                             rate: float = 0.0, seed: int = 0):
    """fused_linear_res's output without autograd: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if h.device.type == "cpu":
        return linear_res_plain(h, w, b, res, period, res_rows, rate, seed)
    return _launch(h, w, b, res, period, res_rows, rate, seed)


def fused_linear_res_backward(h, w, dy, period: int = 0, res_rows: int = 0,
                              rate: float = 0.0, seed: int = 0):
    """(dh, dw, db) of fused_linear_res for upstream gradient dy; dw and db
    in fp32.  The CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if h.device.type == "cpu":
        return linear_res_plain_backward(h, w, dy, period, res_rows, rate,
                                         seed)
    return _launch_backward(h, w, dy, period, res_rows, rate, seed)


class _FusedLinearRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, res, period, res_rows, rate, seed):
        ctx.save_for_backward(h, w)
        ctx.config = (period, res_rows, rate, seed)
        ctx.dtypes = (b.dtype, res.dtype)
        return fused_linear_res_forward(h, w, b, res, period, res_rows, rate,
                                        seed)

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        period, res_rows, _, _ = ctx.config
        dh, dw, db = fused_linear_res_backward(h, w, dy, *ctx.config)
        dres = dy
        if period != 0:
            dy2 = dy.reshape(-1, dy.shape[-1])
            gate = _residual_rows(dy2.shape[0], period, res_rows, dy.device)
            dres = torch.where(gate[:, None], dy2, 0.0).reshape(dy.shape)
        return (dh, dw.to(w.dtype), db.to(ctx.dtypes[0]),
                dres.to(ctx.dtypes[1]), None, None, None, None)


def fused_linear_res(h, w, b, res, period: int = 0, res_rows: int = 0,
                     rate: float = 0.0, seed: int = 0):
    """h: (..., D_in); w: (D_in, D_out); b: (D_out,); res: (..., D_out).
    Differentiable: the backward is `fused_linear_res_backward`.  seed keys
    the dropout mask (ignored at rate 0)."""
    if not _build.needs_grad(h, w, b, res):
        return fused_linear_res_forward(h, w, b, res, period, res_rows, rate,
                                        seed)
    return _FusedLinearRes.apply(h, w, b, res, period, res_rows, rate, seed)


fused_linear_res.launches = 0
fused_linear_res_backward.launches = 0
