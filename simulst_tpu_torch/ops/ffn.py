"""Fused FFN blocks (counterpart of simulst_tpu/ops/ffn_pallas.py).

  fused_ln_ffn_res: y = x + drop_o(fc2(drop_a(act(fc1(LN(x))))))   the
                    Emformer pos_ff block
  fused_ffn:        y = drop_o(fc2(drop_a(act(fc1(x)))))   the decoder FFN

Both take gelu, relu, silu or tanh and both dropout sites, forward and
backward (the JAX package computes silu and tanh in XLA; the port runs
every activation through its kernel).  Both
run the CUDA kernels of csrc/ffn.cu (the forward), ffn_bwd.cu and
ln_ffn_bwd.cu (the backwards; ffn.cuh what they share) on a CUDA tensor,
at any row count and any positive widths D and hidden (`check_widths`): a
D or hidden that is not a multiple of 64 reaches the kernels zero-padded
to the next one, with the real widths beside them (LN's statistics over
the real D, the dropout offsets of the unpadded tensors), and the outputs
are sliced back; above D 1024 the LN row passes walk each row instead of
holding it in registers.  In bf16 the tiled forward's products and both
backwards' five run on the tensor cores (csrc/wgmma.cuh), their bf16
intermediates (xn, h, g, du, h_d) in bf16 buffers; everything else
multiplies in fp32 on the CUDA cores.  On a CPU tensor they run their
plain PyTorch versions (`ln_ffn_res_plain`,
`ln_ffn_res_plain_backward`, `ffn_plain`, `ffn_plain_backward`).  GELU
is the exact erf form.  Weights keep the JAX layout: w1 (D, H), w2 (H,
D).  The plain versions round to the activation dtype where the
kernel does (fc1 input, hidden, the gradients the JAX kernel casts), so
bf16 compares like with like; in fp32 they are the JAX package's
ln_ffn_res_reference and ffn_reference at dropout 0.  LN statistics and the
residual are fp32, eps 1e-5; on the card the LN parameters are fp32
whatever the activation dtype (the kernel raises on others), as the JAX
package passes them, and their gradients are fp32.  Dropout masks come from ops/philox.py: the
hidden site is stream 0 at offset row * H + column, the output site stream
1 at row * D + column, both keyed by the call's seed, so the plain version,
the kernel and the backward all drop the same elements.  The plain
backwards mirror the JAX `_bwd_kernel` / `_ln_ffn_bwd_kernel` formulas,
not autograd.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from simulst_tpu_torch.nn.core import gelu
from simulst_tpu_torch.ops import _build
from simulst_tpu_torch.ops.philox import drop_scale

DIM_STEP = 64        # the kernels' D: a multiple of it (csrc/ffn.cuh
                     # kDimStep); others are padded
# the widths the fused row-block kernel is built for (FFN_FUSED_DIM_DISPATCH:
# its shared memory grows with D); the forward runs its tiled path at every
# row count at the others
FUSED_DIMS = (64, 128, 256, 512)
HIDDEN_CHUNK = 64    # hidden columns per inner step (csrc/ffn.cuh kChunk)
ROWS_PER_BLOCK = 32  # csrc/ffn.cuh kRows
WGRAD_TILE = 64      # k_splits counts weight-gradient tiles of 64 x 64
# the forward runs its tiled path from this many rows up, below it as the
# fused row-block kernel.  fp32: both on the CUDA cores, the same bits,
# the same time on an H100 at 384-512 rows, where the fused kernel still
# has 16 hidden splits; from 513 rows it has 8 (PERF.md)
TILED_MIN_ROWS = 512
# ... in bf16, where the tiled path's products run on the tensor cores
# (within bf16 tolerance of the fused kernel): on an H100 the fused kernel
# is faster up to 256 rows (LN-FFN), the tiled path from 384 on
# (tools/kernel_bitcheck.py --time's bf16 sweep, PERF.md)
BF16_TILED_MIN_ROWS = 384
ACTIVATION_CODES = {"gelu": 0, "relu": 1, "silu": 2, "tanh": 3}


def _act(name: str, u):
    if name == "relu":
        return torch.relu(u)
    if name == "silu":
        return u * torch.sigmoid(u)
    if name == "tanh":
        return torch.tanh(u)
    return gelu(u)


def _act_grad(name: str, u):
    if name == "relu":
        return (u > 0).to(u.dtype)
    if name == "silu":
        s = torch.sigmoid(u)
        return s * (1.0 + u * (1.0 - s))
    if name == "tanh":
        t = torch.tanh(u)
        return 1.0 - t * t
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    return cdf + u * 0.3989422804014327 * torch.exp(-0.5 * u * u)


def _check_activation(activation: str):
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"fused_ffn: activation {activation!r} is not one of "
                         f"{sorted(ACTIVATION_CODES)}")


def _ffn_f32(x, w1, b1, w2, b2, activation="gelu", act_rate=0.0,
             out_rate=0.0, seed=0):
    """drop_o(fc2(drop_a(act(fc1 x)))) in fp32 on (rows, D) input, the
    hidden rounded to x's dtype."""
    u = x.float() @ w1.float() + b1.float()
    h = _act(activation, u)
    if act_rate > 0.0:
        h = h * drop_scale(seed, h.shape, act_rate, 0, x.device)
    y = h.to(x.dtype).float() @ w2.float() + b2.float()
    if out_rate > 0.0:
        y = y * drop_scale(seed, y.shape, out_rate, 1, x.device)
    return y


def ffn_plain(x, w1, b1, w2, b2, activation="gelu", act_rate=0.0,
              out_rate=0.0, seed=0):
    _check_activation(activation)
    x2 = x.reshape(-1, x.shape[-1])
    y = _ffn_f32(x2, w1, b1, w2, b2, activation, act_rate, out_rate, seed)
    return y.to(x.dtype).reshape(*x.shape[:-1], w2.shape[1])


def _ffn_grads(x2, w1, b1, w2, dy2, activation, act_rate, out_rate, seed):
    """(d x2 in fp32, dw1, db1, dw2, db2) of drop_o(fc2(drop_a(act(fc1
    x2)))) on (rows, D) input: the hidden and both masks recomputed, as
    ffn_pallas._bwd_kernel; d x2 is not rounded."""
    d, hidden = w1.shape
    dtype, dev = x2.dtype, x2.device
    n = x2.shape[0]
    u = x2.float() @ w1.float() + b1.float()
    h = _act(activation, u)
    mask_a = (drop_scale(seed, (n, hidden), act_rate, 0, dev)
              if act_rate > 0.0 else None)
    h_d = (h if mask_a is None else h * mask_a).to(dtype).float()
    g = dy2.float()
    if out_rate > 0.0:
        g = g * drop_scale(seed, (n, d), out_rate, 1, dev)
    g = g.to(dtype).float()
    du = (g @ w2.float().T) * _act_grad(activation, u)
    if mask_a is not None:
        du = du * mask_a
    du = du.to(dtype).float()
    return du @ w1.float().T, x2.float().T @ du, du.sum(0), h_d.T @ g, \
        g.sum(0)


def ffn_plain_backward(x, w1, b1, w2, dy, activation="gelu", act_rate=0.0,
                       out_rate=0.0, seed=0):
    """(dx, dw1, db1, dw2, db2) of ffn_plain, the weight gradients in fp32:
    the hidden and both masks recomputed, as ffn_pallas._bwd_kernel."""
    _check_activation(activation)
    d = w1.shape[0]
    dx, *grads = _ffn_grads(x.reshape(-1, d), w1, b1, w2, dy.reshape(-1, d),
                            activation, act_rate, out_rate, seed)
    return (dx.to(x.dtype).reshape(x.shape), *grads)


def _layer_norm_f32(x2, ln_g, ln_b, eps: float = 1e-5):
    """(normed, xhat, 1/sigma) of (rows, D) input, all fp32."""
    xf = x2.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    return xhat * ln_g.float() + ln_b.float(), xhat, inv


def ln_ffn_res_plain(x, ln_g, ln_b, w1, b1, w2, b2, activation="gelu",
                     act_rate=0.0, out_rate=0.0, seed=0):
    _check_activation(activation)
    x2 = x.reshape(-1, x.shape[-1])
    normed, _, _ = _layer_norm_f32(x2, ln_g, ln_b)
    y = _ffn_f32(normed.to(x.dtype), w1, b1, w2, b2, activation, act_rate,
                 out_rate, seed) + x2.float()
    return y.to(x.dtype).reshape(x.shape)


def ln_ffn_res_plain_backward(x, ln_g, ln_b, w1, b1, w2, dy,
                              activation="gelu", act_rate=0.0, out_rate=0.0,
                              seed=0):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) of ln_ffn_res_plain, all but
    dx in fp32, as ffn_pallas._ln_ffn_bwd_kernel: LN and the hidden
    recomputed, dx = LN-backward(dnormed) + dy."""
    _check_activation(activation)
    d = w1.shape[0]
    x2, dy2 = x.reshape(-1, d), dy.reshape(-1, d)
    normed, xhat, inv = _layer_norm_f32(x2, ln_g, ln_b)
    dn, *grads = _ffn_grads(normed.to(x.dtype), w1, b1, w2, dy2, activation,
                            act_rate, out_rate, seed)
    gg = dn * ln_g.float()
    m1 = gg.mean(dim=-1, keepdim=True)
    m2 = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = inv * (gg - m1 - xhat * m2) + dy2.float()
    return (dx.to(x.dtype).reshape(x.shape), (dn * xhat).sum(0), dn.sum(0),
            *grads)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class SlicePlan(NamedTuple):
    """How the FFN kernels cut one call of `rows` rows.

    tiled: the forward runs on tile_product (the LN row pass, the hidden
        product, the output product), else as the fused row-block kernel;
    splits: the forward's hidden splits (grid.y of the fused kernel, so
        that a few rows still fill the SMs), which the tiled path's output
        product takes as its K slices: each output is summed split by split
        in either path, so these fix the forward's bits;
    bwd_splits: the row (K) slices of the backwards' weight products,
        k_splits of their 64 x 64 output tiles, which fix their bits.
    """
    tiled: bool
    splits: int
    bwd_splits: int


def slice_plan(rows: int, hidden: int, sms: int, dim: int,
               dtype=torch.float32) -> SlicePlan:
    """The FFN kernels' plan for `rows` rows of width `dim` and hidden
    width `hidden` on a card of `sms` SMs; hidden / splits is a multiple of
    HIDDEN_CHUNK.  The forward is tiled from TILED_MIN_ROWS rows
    (BF16_TILED_MIN_ROWS in bf16), and at every row count at a width
    outside FUSED_DIMS."""
    tiles = -(-rows // ROWS_PER_BLOCK)
    chunks = hidden // HIDDEN_CHUNK
    splits = 1
    while tiles * splits < sms and chunks % (2 * splits) == 0:
        splits *= 2
    out_tiles = -(-dim // WGRAD_TILE) * -(-hidden // WGRAD_TILE)
    min_rows = BF16_TILED_MIN_ROWS if dtype == torch.bfloat16 \
        else TILED_MIN_ROWS
    return SlicePlan(rows >= min_rows or dim not in FUSED_DIMS, splits,
                     _row_slices(rows, out_tiles, sms))


def _row_slices(rows: int, out_tiles: int, sms: int) -> int:
    want = -(-2 * sms // out_tiles)
    return max(1, min(want, rows // 256))


def k_splits(rows: int, out_tiles: int, device) -> int:
    """Slices of the row (K) axis for a weight-gradient product with
    `out_tiles` 64 x 64 output tiles: about two blocks per SM, and at least
    256 rows per slice.  The backwards' tile_products keep these slices
    whatever their own tile: each weight gradient is the sum of its
    slices' partials, so the slices fix its bits."""
    return _row_slices(rows, out_tiles, _sm_count(device.index))


def check_widths(name: str, d: int, hidden: int) -> None:
    """Raise a ValueError naming the width unless the kernels take it: a
    positive D and a positive hidden."""
    if d < 1:
        raise ValueError(f"{name}: kernel takes a positive D; got D={d}")
    if hidden <= 0:
        raise ValueError(f"{name}: kernel takes a positive hidden width; "
                         f"got {hidden}")


def padded_widths(d: int, hidden: int):
    """(D, hidden) as the kernels take them: each rounded up to a multiple
    of DIM_STEP (= HIDDEN_CHUNK); the call pads to them with zeros."""
    return _build.round_up(d, DIM_STEP), _build.round_up(hidden, HIDDEN_CHUNK)


def _padded_weights(dp, hp, w1, b1, w2, b2=None):
    """w1 (D, H), b1, w2 (H, D) [and b2] zero-padded to (dp, hp)."""
    out = (_build.padded(w1, dp, hp), _build.padded(b1, hp),
           _build.padded(w2, hp, dp))
    return out if b2 is None else out + (_build.padded(b2, dp),)


def _check_shapes(name, x, w1, w2):
    d = x.shape[-1]
    hidden = w1.shape[1]
    if tuple(w1.shape) != (d, hidden) or tuple(w2.shape) != (hidden, d):
        raise ValueError(f"{name}: got x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}; expected "
                         f"w1 (D, hidden), w2 (hidden, D)")
    check_widths(name, d, hidden)
    return d, hidden


def _dropout_sites(act_rate, out_rate, seed):
    """seed, then (on, threshold, 1 / keep) of the hidden and output sites,
    as simulst_ffn and simulst_ffn_bwd take them."""
    a_on, _, a_thr, a_inv = _build.dropout_args(act_rate, seed)
    o_on, _, o_thr, o_inv = _build.dropout_args(out_rate, seed)
    return (seed & (2 ** 64 - 1), a_on, a_thr, a_inv, o_on, o_thr, o_inv)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_ln(name, x, ln_g, ln_b):
    """The LN parameters: fp32 CUDA vectors on x's device."""
    _build.check_cuda(name, ln_g, ln_g=ln_g, ln_b=ln_b)
    if ln_g.dtype != torch.float32 or ln_g.device != x.device:
        raise TypeError(f"{name}: ln_g and ln_b must be float32 on "
                        f"{x.device}, got {ln_g.dtype} on {ln_g.device}")


def _launch(ln_res: bool, x, ln_g, ln_b, w1, b1, w2, b2, activation="gelu",
            act_rate=0.0, out_rate=0.0, seed=0):
    name = "fused_ln_ffn_res" if ln_res else "fused_ffn"
    d_real, h_real = _check_shapes(name, x, w1, w2)
    x2 = x.reshape(-1, d_real).contiguous()
    _build.check_cuda(name, x2, b1=b1, w1=w1, w2=w2, b2=b2)
    if ln_res:
        _check_ln(name, x2, ln_g, ln_b)
    n = x2.shape[0]
    if n == 0:
        return torch.empty_like(x)
    d, hidden = padded_widths(d_real, h_real)
    x2 = _build.padded(x2, d)
    w1, b1, w2, b2 = _padded_weights(d, hidden, w1, b1, w2, b2)
    if ln_res:
        ln_g, ln_b = _build.padded(ln_g, d), _build.padded(ln_b, d)
    y = torch.empty_like(x2)
    plan = slice_plan(n, hidden, _sm_count(x.device.index), d, x.dtype)
    partial = torch.empty(plan.splits, n, d, dtype=torch.float32,
                          device=x.device)
    xn = h = None
    if plan.tiled:   # the products' operands, of the activation dtype
        x2, w1, w2 = (_build.aligned(t) for t in (x2, w1, w2))
        h = torch.empty(n, hidden, dtype=x2.dtype, device=x.device)
        xn = torch.empty(n, d, dtype=x2.dtype, device=x.device) \
            if ln_res else None
    _build.launch(
        "simulst_ffn", _build.dtype_code(x2), int(ln_res),
        ACTIVATION_CODES[activation], x2.data_ptr(),
        ln_g.data_ptr() if ln_res else None, ln_b.data_ptr() if ln_res else None,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        y.data_ptr(), partial.data_ptr(), _ptr(xn), _ptr(h), n, d, hidden,
        plan.splits, d_real, h_real,
        *_dropout_sites(act_rate, out_rate, seed), _build.stream_of(x2))
    (fused_ln_ffn_res if ln_res else fused_ffn).launches += 1
    return _build.unpadded(y, d_real).reshape(x.shape)


def _launch_backward(x, w1, b1, w2, dy, activation, act_rate, out_rate, seed):
    d_real, h_real = _check_shapes("fused_ffn_backward", x, w1, w2)
    x2 = x.reshape(-1, d_real).contiguous()
    dy2 = dy.reshape(-1, d_real).contiguous()
    _build.check_cuda("fused_ffn_backward", x2, w1=w1, b1=b1, w2=w2, dy=dy2)
    d, hidden = padded_widths(d_real, h_real)
    x2, dy2 = _build.padded(x2, d), _build.padded(dy2, d)
    w1, b1, w2 = _padded_weights(d, hidden, w1, b1, w2)
    # the products' operands
    x2, w1, w2 = (_build.aligned(t) for t in (x2, w1, w2))
    n = x2.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    length = 2 * d * hidden + hidden + d
    grads = torch.zeros(length, **f32)
    dx = torch.zeros_like(x2)
    if n:
        splits = slice_plan(n, hidden, _sm_count(x.device.index), d,
                            x.dtype).bwd_splits
        # the products' operands of the activation dtype (bf16: on the
        # tensor cores, dh through an fp32 buffer); in fp32 h_d overwrites u
        act = dict(dtype=x2.dtype, device=x.device)
        u = torch.empty(n, hidden, **f32)
        du, g = torch.empty(n, hidden, **act), torch.empty(n, d, **act)
        f32_path = x2.dtype == torch.float32
        hd = u if f32_path else torch.empty(n, hidden, **act)
        dh = None if f32_path else torch.empty(n, hidden, **f32)
        partial = torch.zeros(splits, length, **f32)
        _build.launch(
            "simulst_ffn_bwd", _build.dtype_code(x2),
            ACTIVATION_CODES[activation], x2.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
            grads.data_ptr(), u.data_ptr(), hd.data_ptr(), du.data_ptr(),
            g.data_ptr(), _ptr(dh), partial.data_ptr(), n, d, hidden,
            splits, d_real, h_real,
            *_dropout_sites(act_rate, out_rate, seed), _build.stream_of(x2))
        fused_ffn_backward.launches += 1
    dw1 = _build.unpadded(grads[:d * hidden].view(d, hidden), d_real,
                          h_real)
    dw2 = _build.unpadded(grads[d * hidden:2 * d * hidden].view(hidden, d),
                          h_real, d_real)
    db1 = grads[2 * d * hidden:2 * d * hidden + h_real]
    db2 = grads[2 * d * hidden + hidden:2 * d * hidden + hidden + d_real]
    return (_build.unpadded(dx, d_real).reshape(x.shape), dw1, db1, dw2,
            db2)


def _launch_ln_backward(x, ln_g, ln_b, w1, b1, w2, dy, activation, act_rate,
                        out_rate, seed):
    name = "fused_ln_ffn_res_backward"
    d_real, h_real = _check_shapes(name, x, w1, w2)
    x2 = x.reshape(-1, d_real).contiguous()
    dy2 = dy.reshape(-1, d_real).contiguous()
    _build.check_cuda(name, x2, w1=w1, b1=b1, w2=w2, dy=dy2)
    _check_ln(name, x2, ln_g, ln_b)
    d, hidden = padded_widths(d_real, h_real)
    x2, dy2 = _build.padded(x2, d), _build.padded(dy2, d)
    ln_g, ln_b = _build.padded(ln_g, d), _build.padded(ln_b, d)
    w1, b1, w2 = _padded_weights(d, hidden, w1, b1, w2)
    w1, w2 = _build.aligned(w1), _build.aligned(w2)   # the products' operands
    n = x2.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    o_dw2, o_db1 = d * hidden, 2 * d * hidden
    o_db2 = o_db1 + hidden
    grads = torch.zeros(o_db2 + 3 * d, **f32)
    dx = torch.zeros_like(x2)
    if n:
        splits = slice_plan(n, hidden, _sm_count(x.device.index), d,
                            x.dtype).bwd_splits
        # the products' operands of the activation dtype (bf16: on the
        # tensor cores, dh through an fp32 buffer); in fp32 h_d overwrites u
        act = dict(dtype=x2.dtype, device=x.device)
        xn, g = torch.empty(n, d, **act), torch.empty(n, d, **act)
        dn = torch.empty(n, d, **f32)
        u = torch.empty(n, hidden, **f32)
        du = torch.empty(n, hidden, **act)
        f32_path = x2.dtype == torch.float32
        hd = u if f32_path else torch.empty(n, hidden, **act)
        dh = None if f32_path else torch.empty(n, hidden, **f32)
        stats = torch.empty(n, 2, **f32)
        partial = torch.zeros(splits, grads.numel(), **f32)
        _build.launch(
            "simulst_ln_ffn_bwd", _build.dtype_code(x2),
            ACTIVATION_CODES[activation], x2.data_ptr(), ln_g.data_ptr(),
            ln_b.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dy2.data_ptr(), dx.data_ptr(), grads.data_ptr(), xn.data_ptr(),
            stats.data_ptr(), u.data_ptr(), hd.data_ptr(), du.data_ptr(),
            g.data_ptr(), dn.data_ptr(), _ptr(dh), partial.data_ptr(), n, d,
            hidden, splits, d_real, h_real,
            *_dropout_sites(act_rate, out_rate, seed), _build.stream_of(x2))
        fused_ln_ffn_res_backward.launches += 1
    return (_build.unpadded(dx, d_real).reshape(x.shape),
            grads[o_db2 + d:o_db2 + d + d_real],
            grads[o_db2 + 2 * d:o_db2 + 2 * d + d_real],
            _build.unpadded(grads[:o_dw2].view(d, hidden), d_real, h_real),
            grads[o_db1:o_db1 + h_real],
            _build.unpadded(grads[o_dw2:o_db1].view(hidden, d), h_real,
                            d_real),
            grads[o_db2:o_db2 + d_real])


def fused_ln_ffn_res_forward(x, ln_g, ln_b, w1, b1, w2, b2, activation="gelu",
                             act_rate=0.0, out_rate=0.0, seed=0):
    """fused_ln_ffn_res's output without autograd: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ln_ffn_res_plain(x, ln_g, ln_b, w1, b1, w2, b2, activation,
                                act_rate, out_rate, seed)
    return _launch(True, x, ln_g, ln_b, w1, b1, w2, b2, activation, act_rate,
                   out_rate, seed)


def fused_ln_ffn_res_backward(x, ln_g, ln_b, w1, b1, w2, dy,
                              activation="gelu", act_rate=0.0, out_rate=0.0,
                              seed=0):
    """(dx, dgamma, dbeta, dw1, db1, dw2, db2) of fused_ln_ffn_res for
    upstream gradient dy; all but dx in fp32.  The CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ln_ffn_res_plain_backward(x, ln_g, ln_b, w1, b1, w2, dy,
                                         activation, act_rate, out_rate, seed)
    _check_activation(activation)
    return _launch_ln_backward(x, ln_g, ln_b, w1, b1, w2, dy, activation,
                               act_rate, out_rate, seed)


class _FusedLNFFNRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_g, ln_b, w1, b1, w2, b2, activation, act_rate,
                out_rate, seed):
        ctx.save_for_backward(x, ln_g, ln_b, w1, b1, w2)
        ctx.config = (activation, act_rate, out_rate, seed)
        ctx.b2_dtype = b2.dtype
        return fused_ln_ffn_res_forward(x, ln_g, ln_b, w1, b1, w2, b2,
                                        activation, act_rate, out_rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, ln_g, ln_b, w1, b1, w2 = ctx.saved_tensors
        dx, dg, dbe, dw1, db1, dw2, db2 = fused_ln_ffn_res_backward(
            x, ln_g, ln_b, w1, b1, w2, dy, *ctx.config)
        return (dx, dg.to(ln_g.dtype), dbe.to(ln_b.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                None, None, None, None)


def fused_ln_ffn_res(x, ln_g, ln_b, w1, b1, w2, b2, activation: str = "gelu",
                     act_rate: float = 0.0, out_rate: float = 0.0,
                     seed: int = 0):
    """y = x + drop_o(fc2(drop_a(act(fc1(LN(x)))))); x (..., D).
    Differentiable: the backward is `fused_ln_ffn_res_backward`.  seed keys
    both dropout masks (ignored at rate 0)."""
    _check_activation(activation)
    if not _build.needs_grad(x, ln_g, ln_b, w1, b1, w2, b2):
        return fused_ln_ffn_res_forward(x, ln_g, ln_b, w1, b1, w2, b2,
                                        activation, act_rate, out_rate, seed)
    return _FusedLNFFNRes.apply(x, ln_g, ln_b, w1, b1, w2, b2, activation,
                                act_rate, out_rate, seed)


def fused_ffn_forward(x, w1, b1, w2, b2, activation="gelu", act_rate=0.0,
                      out_rate=0.0, seed=0):
    """fused_ffn's output without autograd: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, activation, act_rate, out_rate,
                         seed)
    return _launch(False, x, None, None, w1, b1, w2, b2, activation,
                   act_rate, out_rate, seed)


def fused_ffn_backward(x, w1, b1, w2, dy, activation="gelu", act_rate=0.0,
                       out_rate=0.0, seed=0):
    """(dx, dw1, db1, dw2, db2) of fused_ffn for upstream gradient dy; the
    weight gradients in fp32.  The CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if x.device.type == "cpu":
        return ffn_plain_backward(x, w1, b1, w2, dy, activation, act_rate,
                                  out_rate, seed)
    _check_activation(activation)
    return _launch_backward(x, w1, b1, w2, dy, activation, act_rate,
                            out_rate, seed)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation, act_rate, out_rate, seed):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.config = (activation, act_rate, out_rate, seed)
        ctx.b2_dtype = b2.dtype
        return fused_ffn_forward(x, w1, b1, w2, b2, activation, act_rate,
                                 out_rate, seed)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = fused_ffn_backward(x, w1, b1, w2, dy,
                                                    *ctx.config)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None, None, None, None)


def fused_ffn(x, w1, b1, w2, b2, activation: str = "gelu",
              act_rate: float = 0.0, out_rate: float = 0.0, seed: int = 0):
    """y = drop_o(fc2(drop_a(act(fc1(x))))); x (..., D).  Differentiable:
    the backward is `fused_ffn_backward`.  seed keys both dropout masks
    (ignored at rate 0)."""
    _check_activation(activation)
    if not _build.needs_grad(x, w1, b1, w2, b2):
        return fused_ffn_forward(x, w1, b1, w2, b2, activation, act_rate,
                                 out_rate, seed)
    return _FusedFFN.apply(x, w1, b1, w2, b2, activation, act_rate, out_rate,
                           seed)


fused_ln_ffn_res.launches = 0
fused_ln_ffn_res_backward.launches = 0
fused_ffn.launches = 0
fused_ffn_backward.launches = 0
