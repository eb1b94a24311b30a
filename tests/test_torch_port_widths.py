"""The kernels' widths: the wrappers' width checks, their padding, and the
port against the JAX package at widths other than s2t_emformer_s's, on
the CPU.

The wrappers take any positive D (FFN, LN-FFN), FFN hidden, D_in and D_out
(linear-res), head dim (MHA, Emformer attention) and number of conv-pos
channels per group; they
raise a ValueError naming a width no kernel takes (none at all, D not a
whole number of heads or groups) before anything reaches the card
(checked here through the launch paths with CPU tensors).  The
CUDA kernels themselves take D a multiple of 64, a hidden a multiple of
64, D_in a multiple of 32, D_out a multiple of 64, head dims a multiple
of 8 and 1 or a multiple of 4 channels per group: the wrappers zero-pad
the other widths to the next ones and pass the real widths beside them.
That logic runs here against an emulation of the C entries (each entry's
contract computed with torch on the padded buffers it is handed: LN's
statistics over the real D, the dropout offsets of the unpadded tensors,
the real head dim's scale), whose sliced results must equal the
unpadded plain versions (atol / rtol 1e-5, dropout 0.1 included).  The
plain versions are held to JAX's XLA functions at D 16 and 48 (hidden 32
and 48, head dim 4, 2 channels per group): ffn_reference and
ln_ffn_res_reference with their VJPs, attend's, the grouped conv's weight
VJP, and the linear-res and grouped attention kernels in Pallas
interpret mode; atol / rtol 1e-5.  The
parity cases run the JAX package on its XLA paths (the CPU backend) with
jax_default_matmul_precision float32 (tests/conftest.py), weights bridged
with compat/jax_bridge.load_jax_params, at D 512 / 8 heads / FFN 2048 and
D 64 / 4 heads (head dim 16) / FFN 128, 2 + 1 layers: the logits and CTC
logits (every Emformer and decoder layer's forward) rtol 1e-5 / atol 1e-5
of the largest entry, the joint-CTC loss rtol 1e-5 and every parameter's
gradient within 1e-4 of its largest entry (a key bias's of its weight's),
one Adam step's parameters atol 1e-6; the conv-pos weight gradient's
plain version vs the Pallas kernel in interpret mode within 1e-5 of its
largest entry.
"""
import ast
import ctypes
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.nn import attention as jattn  # noqa: E402
from simulst_tpu.nn import conv as jconv  # noqa: E402
from simulst_tpu.ops.conv_pos_pallas import convpos_wgrad_pallas  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import AttnGeom as JGeom  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import \
    emformer_grouped_attention as j_grouped  # noqa: E402
from simulst_tpu.ops.ffn_pallas import (ffn_reference,  # noqa: E402
                                        ln_ffn_res_reference)
from simulst_tpu.ops.linear_res_pallas import fused_linear_drop_res  # noqa: E402
from simulst_tpu.train.optim import OptimConfig as JOptim  # noqa: E402
from simulst_tpu.train.state import create_train_state as j_create  # noqa: E402
from simulst_tpu.train.state import make_train_step as j_make_step  # noqa: E402
from simulst_tpu_torch import multichip  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.ops import conv_pos as tconv  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.ops import _build  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.ops import linear_res as tlr  # noqa: E402
from simulst_tpu_torch.ops import mha as tmha  # noqa: E402
from simulst_tpu_torch.ops.philox import keep_threshold, philox_bits  # noqa: E402
from simulst_tpu_torch.train.optim import OptimConfig  # noqa: E402
from simulst_tpu_torch.train.state import (create_train_state,  # noqa: E402
                                           make_train_step)

# ---------------------------------------------------------------------------
# the width checks
# ---------------------------------------------------------------------------

DIMS = list(range(64, 1025, 64))
HEAD_DIMS = list(range(8, 129, 8))
CHANNELS = [1] + list(range(4, 65, 4))


@pytest.mark.parametrize("d", DIMS)
def test_ffn_takes_every_width_of_the_matrix(d):
    """D every multiple of 64 from 64 to 1024, the hidden every multiple of
    64 up to 4096."""
    for hidden in (64, 2048, 4096, d * 4):
        tffn.check_widths("fused_ffn", d, hidden)


@pytest.mark.parametrize("d,hidden", [(1088, 4096), (1025, 256),
                                      (0, 256), (2048, 64), (256, 0),
                                      (-64, 256), (64, -64)])
def test_ffn_refuses_widths_just_outside(d, hidden):
    """No width at all is refused, naming it; D above 1024 (the old
    maximum, where the LN row passes now walk each row) is taken."""
    if d >= 1 and hidden >= 1:
        tffn.check_widths("fused_ffn", d, hidden)
        return
    with pytest.raises(ValueError, match=f"{d}|{hidden}"):
        tffn.check_widths("fused_ffn", d, hidden)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_attention_takes_every_head_dim_of_the_matrix(hd):
    """Head dims every multiple of 8 from 8 to 128, for the MHA and the
    Emformer attention (one check); the Emformer backward's block fits
    shared memory at s2t_emformer_s's geometry at every one of them."""
    for heads in (1, 4, 8):
        assert tmha.check_head_dim("fused_mha", hd * heads, heads) == hd
    geom = tattn.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                          num_heads=4)
    unit, smem = tattn._fitting_unit("attn", geom, hd, backward=True)
    assert smem <= tattn.SMEM_LIMIT
    assert unit.acc_features == (64 if hd <= 64 else 32)


@pytest.mark.parametrize("d,heads", [(136 * 2, 2), (129, 1), (100, 3),
                                     (64, 0), (0, 4)])
def test_attention_refuses_head_dims_just_outside(d, heads):
    """D not a whole number of heads, no heads, no width are refused;
    head dims above 128 (136, 129: the wide kernels) are taken."""
    if heads > 0 and d > 0 and d % heads == 0:
        assert tmha.check_head_dim("fused_mha", d, heads) == d // heads
        return
    with pytest.raises(ValueError, match="head dim"):
        tmha.check_head_dim("fused_mha", d, heads)


@pytest.mark.parametrize("cg", CHANNELS)
def test_convpos_takes_every_channel_count_of_the_matrix(cg):
    assert tconv.check_channels("convpos_wgrad", cg * 16, 16) == cg


@pytest.mark.parametrize("d,groups", [(1088, 16), (65 * 16, 16), (100, 16),
                                      (64, 0), (0, 16)])
def test_convpos_refuses_channel_counts_just_outside(d, groups):
    """D not a whole number of groups, no groups, no width are refused;
    above 64 channels a group (68, 65) is taken."""
    if groups > 0 and d > 0 and d % groups == 0:
        assert tconv.check_channels("convpos_wgrad", d, groups) == \
            d // groups
        return
    with pytest.raises(ValueError, match="channel"):
        tconv.check_channels("convpos_wgrad", d, groups)


def test_launch_paths_raise_before_the_card():
    """The wrappers' CUDA paths (called here with CPU tensors) raise the
    ValueError naming a width no kernel takes before any launch (no width,
    D not a whole number of heads or groups); D 1088, head dim 136 and 68
    channels a group, above the old maxima, pass the width checks and stop
    only at the device check."""
    x = torch.zeros(4, 1088)
    with pytest.raises(ValueError, match="D=0"):
        tffn._launch(False, torch.zeros(4, 0), None, None,
                     torch.zeros(0, 128), torch.zeros(128),
                     torch.zeros(128, 0), torch.zeros(0))
    with pytest.raises(ValueError, match="D_in=0"):
        tlr._launch(torch.zeros(4, 0), torch.zeros(0, 64), torch.zeros(64),
                    torch.zeros(4, 64), 0, 0, 0.0, 0)
    q = torch.zeros(2, 3, 4 * 136)
    with pytest.raises(ValueError, match="head dim"):
        tmha._launch(q, q, q, torch.ones(2, 3, dtype=torch.int32), 3, False,
                     0.0, 0)
    with pytest.raises(ValueError, match="channel"):
        tconv._launch(torch.zeros(2, 20, 1088), torch.zeros(2, 5, 1088), 16,
                      3)
    with pytest.raises(ValueError, match="must be on"):
        tffn._launch(False, x, None, None, torch.zeros(1088, 128),
                     torch.zeros(128), torch.zeros(128, 1088),
                     torch.zeros(1088))
    with pytest.raises(ValueError, match="must be on"):
        tlr._launch(x, torch.zeros(1088, 64), torch.zeros(64),
                    torch.zeros(4, 64), 0, 0, 0.0, 0)
    with pytest.raises(ValueError, match="must be on"):
        tmha._launch(q, q, q, torch.ones(2, 3, dtype=torch.int32), 4, False,
                     0.0, 0)
    geom = tattn.AttnGeom(U=32, seg=16, lc=16, rc=4, max_mem=2, G=2,
                          num_heads=3)
    q3 = torch.zeros(1, geom.ng, geom.nq, 3 * 136)
    k = torch.zeros(1, geom.tk, 3 * 136)
    with pytest.raises(ValueError, match="must be on"):
        tattn._launch(q3, k, k, torch.full((1,), 32, dtype=torch.int32),
                      geom, 0.0, 0)
    with pytest.raises(ValueError, match="must be on"):
        tconv._launch(torch.zeros(2, 20, 1088), torch.zeros(2, 5, 1088), 16,
                      16)


# the new widths: (D, hidden), head dims and channels per group that reach
# the kernels padded, as the JAX package's tests and dry run use them
NEW_FFN = [(16, 32), (48, 48), (200, 800), (32, 100), (1000, 1)]
NEW_HEAD_DIMS = [4, 8, 12, 50, 100, 1, 127]
NEW_CHANNELS = [2, 3, 6, 50, 63]
NEW_LINEAR = [(16, 16), (48, 200), (200, 48), (1, 1024), (1000, 7)]


@pytest.mark.parametrize("d,hidden", NEW_FFN)
def test_ffn_takes_the_new_widths(d, hidden):
    """D 16 to 1000, hidden 1 to 800: accepted, padded to the next multiple
    of 64 each."""
    tffn.check_widths("fused_ffn", d, hidden)
    dp, hp = tffn.padded_widths(d, hidden)
    assert dp % 64 == hp % 64 == 0 and 0 <= dp - d < 64 \
        and 0 <= hp - hidden < 64


@pytest.mark.parametrize("hd", NEW_HEAD_DIMS)
def test_attention_takes_the_new_head_dims(hd):
    """Head dims 1 to 127 that are not multiples of 8 (and 8): accepted,
    padded to the next multiple of 8; the Emformer backward's block fits
    at s2t_emformer_s's geometry."""
    for heads in (1, 2, 4):
        assert tmha.check_head_dim("fused_mha", hd * heads, heads) == hd
    hdp = tmha.padded_head_dim(hd)
    assert hdp % 8 == 0 and 0 <= hdp - hd < 8
    geom = tattn.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                          num_heads=4)
    assert tattn._fitting_unit("attn", geom, hdp, backward=True)[1] \
        <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("cg", NEW_CHANNELS)
def test_convpos_takes_the_new_channel_counts(cg):
    assert tconv.check_channels("convpos_wgrad", cg * 16, 16) == cg
    assert tconv.padded_channels(cg) % 4 == 0
    assert 0 <= tconv.padded_channels(cg) - cg < 4


@pytest.mark.parametrize("din,dout", NEW_LINEAR)
def test_linear_res_takes_the_new_widths(din, dout):
    tlr.check_widths("fused_linear_res", din, dout)
    dinp, doutp = tlr.padded_widths(din, dout)
    assert dinp % 32 == 0 and doutp % 64 == 0


@pytest.mark.parametrize("din,dout", [(1088, 64), (64, 1088), (0, 64),
                                      (64, 0)])
def test_linear_res_refuses_widths_outside(din, dout):
    """No width is refused; above the old maximum of 1024 is taken."""
    if din >= 1 and dout >= 1:
        tlr.check_widths("fused_linear_res", din, dout)
        return
    with pytest.raises(ValueError, match="D_in"):
        tlr.check_widths("fused_linear_res", din, dout)


# ---------------------------------------------------------------------------
# the padding, through an emulation of the C entries
# ---------------------------------------------------------------------------

RATES = {keep_threshold(r): r for r in (0.1,)}   # threshold -> rate


def _buf(ptr, *shape, dtype=ctypes.c_float):
    """The tensor of `shape` at a CPU pointer (sharing its memory)."""
    n = int(np.prod(shape))
    if n == 0:
        return torch.zeros(shape)
    arr = np.ctypeslib.as_array((dtype * n).from_address(ptr))
    return torch.from_numpy(arr).view(*shape)


def _mult(seed, on, thr, inv, rows, cols, real, stream):
    """The kernels' dropout multiplier of a (rows, cols) site whose first
    `real` columns are the real ones (common.cuh unpadded_offset)."""
    if not on:
        return torch.ones(rows, cols)
    i = torch.arange(rows * cols, dtype=torch.int64).reshape(rows, cols)
    off = (i // cols) * real + i % cols
    return torch.where(philox_bits(seed, off, stream) < thr,
                       torch.tensor(inv, dtype=torch.float32),
                       torch.tensor(0.0))


def _pads_zero(t, real):
    """The columns past `real` of the last axis are exactly zero."""
    assert not t[..., real:].any()


def _ln_emulated(x, g, b, d_real):
    """LN of padded rows with statistics over the real columns."""
    mask = (torch.arange(x.shape[1]) < d_real).float()
    mean = x.sum(1, keepdim=True) / d_real
    xc = (x - mean) * mask
    inv = torch.rsqrt((xc * xc).sum(1, keepdim=True) / d_real + 1e-5)
    xhat = (x - mean) * inv
    return xhat * g + b, xhat, inv


def _emu_ffn(dtype, ln_res, act, x, ln_g, ln_b, w1, b1, w2, b2, y, partial,
             xn, h, n, d, hid, splits, d_real, h_real, seed, a_on, a_thr,
             a_inv, o_on, o_thr, o_inv, stream):
    name = [k for k, v in tffn.ACTIVATION_CODES.items() if v == act][0]
    X = _buf(x, n, d)
    _pads_zero(X, d_real)
    W1, B1, W2, B2 = _buf(w1, d, hid), _buf(b1, hid), _buf(w2, hid, d), \
        _buf(b2, d)
    inp = _ln_emulated(X, _buf(ln_g, d), _buf(ln_b, d), d_real)[0] \
        if ln_res else X
    hh = tffn._act(name, inp @ W1 + B1) * _mult(seed, a_on, a_thr, a_inv, n,
                                               hid, h_real, 0)
    out = (hh @ W2 + B2) * _mult(seed, o_on, o_thr, o_inv, n, d, d_real, 1)
    _buf(y, n, d)[:] = out + X if ln_res else out


def _emu_ffn_grads(name, inp, W1, B1, W2, DY, n, d, hid, d_real, h_real,
                   seed, a, o):
    g = DY * _mult(seed, *o, n, d, d_real, 1)
    u = inp @ W1 + B1
    ma = _mult(seed, *a, n, hid, h_real, 0)
    du = (g @ W2.T) * tffn._act_grad(name, u) * ma
    hd = tffn._act(name, u) * ma
    return du @ W1.T, torch.cat([(inp.T @ du).reshape(-1),
                                 (hd.T @ g).reshape(-1), du.sum(0),
                                 g.sum(0)])


def _emu_ffn_bwd(dtype, act, x, w1, b1, w2, dy, dx, grads, u, hd, du, g,
                 dh, partial, n, d, hid, splits, d_real, h_real, seed, a_on,
                 a_thr, a_inv, o_on, o_thr, o_inv, stream):
    name = [k for k, v in tffn.ACTIVATION_CODES.items() if v == act][0]
    X, DY = _buf(x, n, d), _buf(dy, n, d)
    _pads_zero(DY, d_real)
    dxx, gr = _emu_ffn_grads(name, X, _buf(w1, d, hid), _buf(b1, hid),
                             _buf(w2, hid, d), DY, n, d, hid, d_real, h_real,
                             seed, (a_on, a_thr, a_inv), (o_on, o_thr, o_inv))
    _buf(dx, n, d)[:] = dxx
    _buf(grads, gr.numel())[:] = gr


def _emu_ln_ffn_bwd(dtype, act, x, ln_g, ln_b, w1, b1, w2, dy, dx, grads,
                    xn, stats, u, hd, du, g, dn, dh, partial, n, d, hid,
                    splits, d_real, h_real, seed, a_on, a_thr, a_inv, o_on,
                    o_thr, o_inv, stream):
    name = [k for k, v in tffn.ACTIVATION_CODES.items() if v == act][0]
    X, DY, G = _buf(x, n, d), _buf(dy, n, d), _buf(ln_g, d)
    normed, xhat, inv = _ln_emulated(X, G, _buf(ln_b, d), d_real)
    dnn, gr = _emu_ffn_grads(name, normed, _buf(w1, d, hid), _buf(b1, hid),
                             _buf(w2, hid, d), DY, n, d, hid, d_real, h_real,
                             seed, (a_on, a_thr, a_inv), (o_on, o_thr, o_inv))
    gg = dnn * G
    m1 = gg.sum(1, keepdim=True) / d_real
    m2 = (gg * xhat).sum(1, keepdim=True) / d_real
    _buf(dx, n, d)[:] = inv * (gg - m1 - xhat * m2) + DY
    gr = torch.cat([gr, (dnn * xhat).sum(0), dnn.sum(0)])
    _buf(grads, gr.numel())[:] = gr


def _lr_gate(n, dout, period, res_rows):
    rows = torch.arange(n)[:, None]
    return (rows % period < res_rows) if period else torch.ones(n, 1,
                                                                dtype=bool)


def _emu_linear_res(dtype, h, w, b, res, y, u, n, din, dout, dout_real,
                    period, res_rows, path, on, seed, thr, inv, stream):
    H, RES = _buf(h, n, din), _buf(res, n, dout)
    _pads_zero(RES, dout_real)
    u = H @ _buf(w, din, dout) + _buf(b, dout)
    m = _mult(seed, on, thr, inv, n, dout, dout_real, 0)
    _buf(y, n, dout)[:] = torch.where(_lr_gate(n, dout, period, res_rows),
                                      u * m + RES, u)


def _emu_linear_res_bwd(dtype, h, w, dy, dh, grads, du, partial, n, din,
                        dout, dout_real, period, res_rows, splits, on, seed,
                        thr, inv, stream):
    H, W, DY = _buf(h, n, din), _buf(w, din, dout), _buf(dy, n, dout)
    g = DY * torch.where(_lr_gate(n, dout, period, res_rows),
                         _mult(seed, on, thr, inv, n, dout, dout_real, 0),
                         1.0)
    _buf(dh, n, din)[:] = g @ W.T
    _buf(grads, din * dout + dout)[:] = torch.cat([(H.T @ g).reshape(-1),
                                                   g.sum(0)])


def _heads_cut(t, heads, hd_real):
    """(..., H hdp) padded heads -> (..., H hd_real), the pads checked zero."""
    t = t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)
    _pads_zero(t, hd_real)
    return t[..., :hd_real].reshape(*t.shape[:-2], heads * hd_real)


def _heads_put(dst, t, heads):
    """Write (..., H hd_real) into the padded (..., H hdp) dst, zeros past
    each head's hd_real."""
    dst = dst.view(*dst.shape[:-1], heads, dst.shape[-1] // heads)
    hd = t.shape[-1] // heads
    dst.zero_()
    dst[..., :hd] = t.reshape(*t.shape[:-1], heads, hd)


def _emu_mha_fwd(dtype, q, k, v, kmask, out, lse, B, Tq, Tk, D, heads,
                 hd_real, causal, path, on, seed, thr, inv, stream):
    qs = [_heads_cut(_buf(p, B, t, D), heads, hd_real)
          for p, t in ((q, Tq), (k, Tk), (v, Tk))]
    km = _buf(kmask, B, Tk, dtype=ctypes.c_int32)
    rate = RATES[thr] if on else 0.0
    _heads_put(_buf(out, B, Tq, D),
               tmha.mha_plain(*qs, km, heads, bool(causal), rate, seed),
               heads)


def _emu_mha_bwd(dtype, q, k, v, kmask, out, lse, dout, dq, dk, dv, delta,
                 ds, B, Tq, Tk, D, heads, hd_real, causal, on, seed, thr,
                 inv, stream):
    qs = [_heads_cut(_buf(p, B, t, D), heads, hd_real)
          for p, t in ((q, Tq), (k, Tk), (v, Tk), (dout, Tq))]
    km = _buf(kmask, B, Tk, dtype=ctypes.c_int32)
    rate = RATES[thr] if on else 0.0
    got = tmha.mha_plain_backward(*qs[:3], km, qs[3], heads, bool(causal),
                                  rate, seed)
    for p, t, g in zip((dq, dk, dv), (Tq, Tk, Tk), got):
        _heads_put(_buf(p, B, t, D), g, heads)


def _emu_geom(batch, ng, nq, dim, heads, hd_real, seg, lc, rc, max_mem, G,
              tk, unit_cols, smem):
    n = ng * G
    return tattn.AttnGeom(U=n * seg, seg=seg, lc=lc, rc=rc, max_mem=max_mem,
                          G=G, num_heads=heads)


def _emu_attn(dtype, q3, k, v, lengths, kid, seg_eid, out, batch, ng, nq,
              dim, heads, hd_real, seg, lc, rc, max_mem, G, tk, unit_cols,
              smem, on, seed, thr, inv, stream):
    geom = _emu_geom(batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
                     max_mem, G, tk, unit_cols, smem)
    ins = [_heads_cut(_buf(q3, batch, ng, nq, dim), heads, hd_real)] + [
        _heads_cut(_buf(p, batch, tk, dim), heads, hd_real) for p in (k, v)]
    lens = _buf(lengths, batch, dtype=ctypes.c_int32)
    rate = RATES[thr] if on else 0.0
    _heads_put(_buf(out, batch, ng, nq, dim), tattn.grouped_attention_plain(
        *ins, lens, geom, rate, seed), heads)


def _emu_attn_bwd(dtype, q3, k, v, lengths, kid, seg_eid, dout, dq, dk, dv,
                  probs, dk_part, dv_part, batch, ng, nq, dim, heads,
                  hd_real, seg, lc, rc, max_mem, G, tk, unit_cols, smem, on,
                  seed, thr, inv, stream):
    geom = _emu_geom(batch, ng, nq, dim, heads, hd_real, seg, lc, rc,
                     max_mem, G, tk, unit_cols, smem)
    qd = [_heads_cut(_buf(p, batch, ng, nq, dim), heads, hd_real)
          for p in (q3, dout)]
    kv = [_heads_cut(_buf(p, batch, tk, dim), heads, hd_real) for p in (k, v)]
    lens = _buf(lengths, batch, dtype=ctypes.c_int32)
    rate = RATES[thr] if on else 0.0
    got = tattn.grouped_attention_plain_backward(qd[0], *kv, lens, qd[1],
                                                 geom, rate, seed)
    for p, shape, g in zip((dq, dk, dv), ((batch, ng, nq, dim),
                                          (batch, tk, dim), (batch, tk, dim)),
                           got):
        _heads_put(_buf(p, *shape), g, heads)


def _emu_convpos(dtype, xp, dy, dw, partial, b, t, taps, d, groups, splits,
                 stream):
    cg = d // groups
    assert cg == 1 or cg % 4 == 0
    _buf(dw, d, cg, taps)[:] = tconv.convpos_wgrad_plain(
        _buf(xp, b, t + taps - 1, d), _buf(dy, b, t, d), taps, groups)


EMULATED = {"simulst_ffn": _emu_ffn, "simulst_ffn_bwd": _emu_ffn_bwd,
            "simulst_ln_ffn_bwd": _emu_ln_ffn_bwd,
            "simulst_linear_res": _emu_linear_res,
            "simulst_linear_res_bwd": _emu_linear_res_bwd,
            "simulst_mha_fwd": _emu_mha_fwd, "simulst_mha_bwd": _emu_mha_bwd,
            "simulst_emformer_attn": _emu_attn,
            "simulst_emformer_attn_bwd": _emu_attn_bwd,
            "simulst_convpos_wgrad": _emu_convpos}


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers' launch paths on CPU tensors, each C entry emulated;
    returns the entries called, with the widths they were handed."""
    calls = []

    def launch(name, *args):
        assert len(args) == len(_build.SIGNATURES[name]), name
        calls.append(name)
        EMULATED[name](*args)

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(tffn, "_sm_count", lambda index: 132)
    return calls


EMU_TOL = dict(atol=1e-5, rtol=1e-5)


def _emu_rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize("d,hidden", [(16, 32), (48, 48), (200, 100),
                                      (64, 64), (1280, 64), (1090, 40)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ffn_padding_matches_the_plain_versions(emulated, d, hidden, rate):
    """The FFN and LN-FFN forward and backward through their launch paths
    (padded to D and hidden multiples of 64, the real widths passed) at 5
    and 40 rows: the sliced outputs and gradients equal the unpadded plain
    versions', the dropout masks included; D 64 / hidden 64 pads
    nothing."""
    rng = np.random.RandomState(d + hidden)
    # above D 1024, weights of 1 / sqrt(D), so that the fp32 sums over D
    # of the emulation and of the plain version stay within EMU_TOL
    s1 = s2 = 0.2 if d <= 1024 else d ** -0.5
    ln = (1 + _emu_rand(rng, d, scale=0.1), _emu_rand(rng, d, scale=0.1))
    w1, b1 = _emu_rand(rng, d, hidden, scale=s1), _emu_rand(rng, hidden)
    w2, b2 = _emu_rand(rng, hidden, d, scale=s2), _emu_rand(rng, d)
    cfg = ("gelu", rate, rate, 31)
    for rows in (5, 40):
        x, dy = _emu_rand(rng, rows, d), _emu_rand(rng, rows, d)
        torch.testing.assert_close(
            tffn._launch(True, x, *ln, w1, b1, w2, b2, *cfg),
            tffn.ln_ffn_res_plain(x, *ln, w1, b1, w2, b2, *cfg), **EMU_TOL)
        torch.testing.assert_close(
            tffn._launch(False, x, None, None, w1, b1, w2, b2, *cfg),
            tffn.ffn_plain(x, w1, b1, w2, b2, *cfg), **EMU_TOL)
        got = tffn._launch_ln_backward(x, *ln, w1, b1, w2, dy, *cfg)
        want = tffn.ln_ffn_res_plain_backward(x, *ln, w1, b1, w2, dy, *cfg)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            torch.testing.assert_close(g, w, **EMU_TOL)
        got = tffn._launch_backward(x, w1, b1, w2, dy, *cfg)
        want = tffn.ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            torch.testing.assert_close(g, w, **EMU_TOL)
    assert set(emulated) == {"simulst_ffn", "simulst_ffn_bwd",
                             "simulst_ln_ffn_bwd"}


@pytest.mark.parametrize("din,dout", [(16, 16), (48, 200), (200, 48),
                                      (64, 64), (1280, 1280), (1300, 1090)])
@pytest.mark.parametrize("period,res_rows", [(0, 0), (7, 5)])
def test_linear_res_padding_matches_the_plain_versions(emulated, din, dout,
                                                       period, res_rows):
    """The linear-res forward and backward through their launch paths
    (D_in padded to a multiple of 32, D_out of 64, the real D_out passed)
    at rate 0.1, with and without the residual gate: equal to the unpadded
    plain versions."""
    rng = np.random.RandomState(din * dout + period)
    h, dy = _emu_rand(rng, 3, 9, din), _emu_rand(rng, 3, 9, dout)
    w, b = _emu_rand(rng, din, dout, scale=0.2), _emu_rand(rng, dout)
    res = _emu_rand(rng, 3, 9, dout)
    cfg = (period, res_rows, 0.1, 7)
    torch.testing.assert_close(tlr._launch(h, w, b, res, *cfg),
                               tlr.linear_res_plain(h, w, b, res, *cfg),
                               **EMU_TOL)
    got = tlr._launch_backward(h, w, dy, *cfg)
    want = tlr.linear_res_plain_backward(h, w, dy, *cfg)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and g.is_contiguous()
        torch.testing.assert_close(g, w_, **EMU_TOL)
    assert set(emulated) == {"simulst_linear_res", "simulst_linear_res_bwd"}


@pytest.mark.parametrize("d,heads", [(16, 4), (48, 4), (100, 1), (64, 4),
                                     (320, 2), (250, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_padding_matches_the_plain_versions(emulated, d, heads,
                                                      rate):
    """fused_mha and the grouped attention, forward and backward, through
    their launch paths (each head padded to a multiple of 8, the real head
    dim passed for the scale): equal to the unpadded plain versions; head
    dims 4, 12, 100 and 16 (unpadded)."""
    rng = np.random.RandomState(d + heads)
    q, dout = _emu_rand(rng, 3, 5, d), _emu_rand(rng, 3, 5, d)
    k, v = _emu_rand(rng, 3, 7, d), _emu_rand(rng, 3, 7, d)
    kmask = torch.tensor([[1] * 7, [1] * 4 + [0] * 3, [1] * 6 + [0]],
                         dtype=torch.int32)
    for causal in (False, True):
        args = (q, k, v, kmask, heads, causal, rate, 5)
        out, lse = tmha._launch(*args)
        torch.testing.assert_close(out, tmha.mha_plain(*args), **EMU_TOL)
        got = tmha._launch_backward(q, k, v, kmask, out, lse, dout,
                                    *args[4:])
        want = tmha.mha_plain_backward(q, k, v, kmask, dout, *args[4:])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **EMU_TOL)
    geom = tattn.AttnGeom(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                          num_heads=heads)
    q3, do3 = (_emu_rand(rng, 2, geom.ng, geom.nq, d) for _ in range(2))
    k3, v3 = (_emu_rand(rng, 2, geom.tk, d) for _ in range(2))
    lengths = torch.tensor([32, 21], dtype=torch.int32)
    args = (q3, k3, v3, lengths, geom, rate, 77)
    torch.testing.assert_close(tattn._launch(*args),
                               tattn.grouped_attention_plain(*args),
                               **EMU_TOL)
    got = tattn._launch_backward(q3, k3, v3, lengths, do3, *args[4:])
    want = tattn.grouped_attention_plain_backward(q3, k3, v3, lengths, do3,
                                                  *args[4:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **EMU_TOL)
    assert set(emulated) == {"simulst_mha_fwd", "simulst_mha_bwd",
                             "simulst_emformer_attn",
                             "simulst_emformer_attn_bwd"}


@pytest.mark.parametrize("cg", [2, 3, 6, 50, 4, 1, 96, 126])
def test_convpos_padding_matches_the_plain_version(emulated, cg):
    """The conv-pos weight gradient through its launch path (each group's
    channels padded to a multiple of 4): the sliced gradient equals the
    unpadded plain version's; 4 and 1 channels pad nothing."""
    rng = np.random.RandomState(cg)
    d, taps = 4 * cg, 5
    xp, dy = _emu_rand(rng, 2, 11 + taps - 1, d), _emu_rand(rng, 2, 11, d)
    torch.testing.assert_close(tconv._launch(xp, dy, taps, 4),
                               tconv.convpos_wgrad_plain(xp, dy, taps, 4),
                               **EMU_TOL)
    assert emulated == ["simulst_convpos_wgrad"]


# ---------------------------------------------------------------------------
# the plain versions vs JAX's functions at the new widths
# ---------------------------------------------------------------------------

def _jax_vjp(fn, arrays, dy):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize("d,hidden", [(16, 32), (48, 48)])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_ffn_plain_versions_match_jax_at_the_new_widths(d, hidden,
                                                        activation):
    """ln_ffn_res_plain / ffn_plain and their backwards vs JAX's
    ln_ffn_res_reference / ffn_reference and jax.vjp of them, dropout 0."""
    rng = np.random.RandomState(d)
    x, dy = (rng.randn(6, d).astype(np.float32) for _ in range(2))
    ws = [(1 + 0.1 * rng.randn(d)).astype(np.float32),
          (0.1 * rng.randn(d)).astype(np.float32),
          (0.2 * rng.randn(d, hidden)).astype(np.float32),
          (0.1 * rng.randn(hidden)).astype(np.float32),
          (0.2 * rng.randn(hidden, d)).astype(np.float32),
          (0.1 * rng.randn(d)).astype(np.float32)]
    tt = [torch.from_numpy(a) for a in [x] + ws + [dy]]
    want, grads = _jax_vjp(lambda *a: ln_ffn_res_reference(
        *a, None, None, activation=activation), [x] + ws, dy)
    np.testing.assert_allclose(tffn.ln_ffn_res_plain(
        *tt[:7], activation).numpy(), want, atol=1e-5, rtol=1e-5)
    got = tffn.ln_ffn_res_plain_backward(*tt[:6], tt[7], activation)
    for g, w in zip(got, grads[:6]):     # dx, dg, db, dw1, db1, dw2
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[6].numpy(), grads[6], atol=1e-5,
                               rtol=1e-5)
    want, grads = _jax_vjp(lambda *a: ffn_reference(
        *a, None, None, activation=activation), [x] + ws[2:], dy)
    np.testing.assert_allclose(tffn.ffn_plain(
        tt[0], *tt[3:7], activation).numpy(), want, atol=1e-5, rtol=1e-5)
    got = tffn.ffn_plain_backward(tt[0], *tt[3:6], tt[7], activation)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,heads", [(16, 4), (48, 4)])
@pytest.mark.parametrize("causal", [False, True])
def test_mha_plain_versions_match_jax_at_the_new_head_dims(d, heads, causal):
    """mha_plain and its backward vs JAX's attend (XLA) and jax.vjp of it,
    head dims 4 and 12, a ragged key mask, dropout 0."""
    rng = np.random.RandomState(d + causal)
    q, dout = (rng.randn(2, 5, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 5, d).astype(np.float32) for _ in range(2))
    valid = np.array([[1] * 5, [1] * 3 + [0] * 2], bool)

    def j_mha(q, k, v):
        split = lambda t: t.reshape(2, 5, heads, -1).transpose(0, 2, 1, 3)  # noqa: E731
        bias = None
        if causal:
            bias = jnp.where(jnp.tril(jnp.ones((5, 5), bool)), 0.0, -1e30)
        out, _ = jattn.attend(split(q), split(k), split(v), bias=bias,
                              key_valid=jnp.asarray(valid))
        return out.transpose(0, 2, 1, 3).reshape(2, 5, d)

    want, grads = _jax_vjp(j_mha, [q, k, v], dout)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    km = torch.from_numpy(valid.astype(np.int32))
    np.testing.assert_allclose(tmha.mha_plain(tq, tk, tv, km, heads, causal)
                               .numpy(), want, atol=1e-5, rtol=1e-5)
    got = tmha.mha_plain_backward(tq, tk, tv, km, tdo, heads, causal)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("din,dout", [(16, 16), (48, 16)])
def test_linear_res_plain_versions_match_jax_at_the_new_widths(din, dout):
    """linear_res_plain and its backward vs the JAX package's
    fused_linear_drop_res in Pallas interpret mode (and jax.vjp of it),
    with the Emformer gate, dropout 0."""
    rng = np.random.RandomState(din + dout)
    h = rng.randn(12, din).astype(np.float32)
    w = (0.2 * rng.randn(din, dout)).astype(np.float32)
    b, res = (rng.randn(*s).astype(np.float32) for s in ((dout,),
                                                         (12, dout)))
    dy = rng.randn(12, dout).astype(np.float32)
    want, grads = _jax_vjp(lambda h, w, b, r: fused_linear_drop_res(
        h, w, b, r, jnp.zeros((1,), jnp.int32), period=6, res_rows=4,
        interpret=True), [h, w, b, res], dy)
    th, tw, tb, tr, tdy = (torch.from_numpy(a) for a in (h, w, b, res, dy))
    np.testing.assert_allclose(tlr.linear_res_plain(th, tw, tb, tr, 6, 4)
                               .numpy(), want, atol=1e-5, rtol=1e-5)
    got = tlr.linear_res_plain_backward(th, tw, tdy, 6, 4)
    for g, w_ in zip(got, grads[:3]):
        np.testing.assert_allclose(g.numpy(), w_, atol=1e-5, rtol=1e-5)


def test_grouped_attention_plain_versions_match_jax_at_head_dim_4():
    """grouped_attention_plain and its backward vs the JAX package's
    emformer_grouped_attention in Pallas interpret mode (and jax.vjp of
    it) at D 16 over 4 heads, a ragged length, dropout 0."""
    geom = tattn.AttnGeom(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                          num_heads=4)
    rng = np.random.RandomState(4)
    q3, dout = (rng.randn(2, geom.ng, geom.nq, 16).astype(np.float32)
                for _ in range(2))
    k, v = (rng.randn(2, geom.tk, 16).astype(np.float32) for _ in range(2))
    lengths = np.array([32, 21], np.int32)
    jgeom = JGeom(**geom._asdict())
    want, grads = _jax_vjp(lambda q, k, v: j_grouped(
        q, k, v, jnp.asarray(lengths), jnp.zeros((1,), jnp.int32), None,
        jgeom, 0.0, True), [q3, k, v], dout)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q3, k, v, dout))
    tl = torch.from_numpy(lengths)
    np.testing.assert_allclose(tattn.grouped_attention_plain(
        tq, tk, tv, tl, geom).numpy(), want, atol=1e-5, rtol=1e-5)
    got = tattn.grouped_attention_plain_backward(tq, tk, tv, tl, tdo, geom)
    for g, w in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("d,groups", [(32, 16), (48, 16)])
def test_convpos_wgrad_plain_matches_jax_at_the_new_channel_counts(d,
                                                                   groups):
    """convpos_wgrad_plain at 2 and 3 channels a group vs jax.vjp of the
    JAX package's grouped convolution (XLA) in its weight, 16 taps."""
    b, t, taps = 2, 12, 16
    rng = np.random.RandomState(d)
    xp = rng.randn(b, t + taps - 1, d).astype(np.float32)
    dy = rng.randn(b, t, d).astype(np.float32)
    w = rng.randn(taps, d // groups, d).astype(np.float32)
    _, vjp = jax.vjp(lambda w: jconv._conv1d(jnp.asarray(xp), w, 1, groups),
                     jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(dy))[0])      # (K, D / groups, D)
    got = tconv.convpos_wgrad_plain(torch.from_numpy(xp),
                                    torch.from_numpy(dy), taps, groups)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (2, 1, 0)),
                               atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the port vs the JAX package at other widths
# ---------------------------------------------------------------------------

BASE = dict(vocab_size=40, input_feat=8, conv_channels=16, encoder_layers=2,
            decoder_layers=1, segment_length=16, left_context=32,
            right_context=8, max_memory=2, max_target_positions=64,
            ctc_layer=True, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0)
WIDTHS = {"d512": dict(embed_dim=512, encoder_heads=8, decoder_heads=8,
                       ffn_dim=2048, decoder_ffn_dim=2048),
          "d64-hd16": dict(embed_dim=64, encoder_heads=4, decoder_heads=4,
                           ffn_dim=128, decoder_ffn_dim=128)}
T = 128          # feature frames: U = 32 after subsampling, 2 segments
OPTIM = dict(lr=1e-3, warmup_updates=10000, clip_norm=10.0)
ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true", "--no-specaugment"]


def _close_to_largest(got, want, rtol, scale=None, name=""):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    ref = np.abs(np.asarray(want if scale is None else scale)).max()
    assert err <= rtol * max(ref, 1e-30), (name, err, ref)


def _batch():
    rng = np.random.RandomState(11)
    feats = rng.randn(2, T, 8).astype(np.float32)
    target = np.ones((2, 8), np.int32)
    prev = np.ones((2, 8), np.int32)
    for j, n in enumerate((7, 4)):
        toks = np.append(rng.randint(4, 40, n), 2)
        target[j, :n + 1] = toks
        prev[j, :n + 1] = np.append(2, toks[:-1])
    return {"feats": feats, "feat_lengths": np.array([T, 90], np.int32),
            "target": target, "prev_tokens": prev}


def _jax_loss(jmodel):
    def fn(params, batch, rng):
        logits, extra = jmodel.forward(params, batch["feats"],
                                       batch["feat_lengths"],
                                       batch["prev_tokens"])
        return jjc.joint_ctc_loss(logits, extra, batch["target"],
                                  jjc.JointCTCConfig())
    return fn


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def wide_pair(request):
    cfg = dict(BASE, **WIDTHS[request.param])
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**cfg))
    jp = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, extra = jax.jit(lambda p, b: jmodel.forward(
        p, b["feats"], b["feat_lengths"], b["prev_tokens"]))(jp, jb)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        _jax_loss(jmodel), has_aux=True))(jp, jb, None)
    jstate, jm = jax.jit(j_make_step(_jax_loss(jmodel), JOptim(**OPTIM)))(
        j_create(jp, JOptim(**OPTIM)), jb, jax.random.PRNGKey(0))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    return dict(cfg=cfg, params=as_np(jp), batch=batch,
                logits=np.asarray(logits),
                ctc_logits=np.asarray(extra["ctc_logits"]), loss=float(loss),
                grads=as_np(grads), stepped=as_np(jstate.params),
                gnorm=float(jm["gnorm"]))


def _port_model(pair):
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**pair["cfg"]),
                                  device="cpu")
    model.load_state_dict(load_jax_params(pair["params"]))
    return model


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_forward_matches_jax_at_other_widths(wide_pair):
    """The decoder's logits and the CTC head's (every Emformer layer and
    the decoder layer forward): within 1e-5 of the largest entry."""
    model = _port_model(wide_pair)
    b = _torch_batch(wide_pair["batch"])
    with torch.no_grad():
        logits, extra = model(b["feats"], b["feat_lengths"],
                              b["prev_tokens"])
    _close_to_largest(logits.numpy(), wide_pair["logits"], 1e-5)
    _close_to_largest(extra["ctc_logits"].numpy(), wide_pair["ctc_logits"],
                      1e-5)


def test_loss_and_gradients_match_jax_at_other_widths(wide_pair):
    """The joint-CTC loss rtol 1e-5 and every parameter's gradient (the
    Emformer layers', the conv-pos weight norm's, the decoder layer's)
    within 1e-4 of its largest entry."""
    model = _port_model(wide_pair)
    loss_fn = tcli.build_loss(tcli.parse_args(ASR_ARGS), None)
    loss, _ = loss_fn(model, _torch_batch(wide_pair["batch"]), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), wide_pair["loss"], rtol=1e-5)
    ref = load_jax_params(wide_pair["grads"])
    assert sorted(n for n, _ in model.named_parameters()) == sorted(ref)
    for name, p in model.named_parameters():
        scale = ref[name[:-len("bias")] + "weight"] \
            if name.endswith("k_proj.bias") else ref[name]
        _close_to_largest(p.grad.numpy(), ref[name], 1e-4, scale=scale,
                          name=name)


def test_train_step_matches_jax_at_other_widths(wide_pair):
    """One Adam step (lr 1e-3, warmup 10000, clip 10): the gradient norm
    rtol 1e-5, every updated parameter atol 1e-6."""
    model = _port_model(wide_pair)
    state = create_train_state(model, OptimConfig(**OPTIM))
    state, metrics = make_train_step(
        tcli.build_loss(tcli.parse_args(ASR_ARGS), None),
        OptimConfig(**OPTIM))(state, _torch_batch(wide_pair["batch"]))
    np.testing.assert_allclose(float(metrics["gnorm"]), wide_pair["gnorm"],
                               rtol=1e-5)
    for name, p in load_jax_params(wide_pair["stepped"]).items():
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   p.numpy(), atol=1e-6, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("d,groups", [(512, 16), (64, 16), (64, 64)])
def test_convpos_wgrad_matches_pallas_interpret_at_other_widths(d, groups):
    """The conv-pos weight gradient at 32, 4 and 1 channels a group (D 512
    and 64 in 16 groups, D 64 depthwise), 16 taps: the plain version (what
    the kernel is held to on the card) vs the Pallas kernel in interpret
    mode, within 1e-5 of the largest entry."""
    b, t, k = 2, 12, 16
    rng = np.random.RandomState(d + groups)
    xp = rng.randn(b, t + k - 1, d).astype(np.float32)
    dy = rng.randn(b, t, d).astype(np.float32)
    want = np.asarray(convpos_wgrad_pallas(jnp.asarray(xp), jnp.asarray(dy),
                                           k, groups, interpret=True))
    got = tconv.convpos_wgrad_plain(torch.from_numpy(xp),
                                    torch.from_numpy(dy), k, groups)
    _close_to_largest(got.numpy(), np.transpose(want, (2, 1, 0)), 1e-5)


def test_streaming_config_is_the_jax_dry_runs_model():
    """multichip.streaming_config equals, field by field, the CIFConfig the
    JAX package's sharded-streaming dry run builds (__graft_entry__.py,
    read as source): 16 wide, FFN 32, 2 heads."""
    tree = ast.parse((Path(__file__).resolve().parent.parent
                      / "__graft_entry__.py").read_text())
    calls = [{k.arg: ast.literal_eval(k.value) for k in node.keywords}
             for node in ast.walk(tree) if isinstance(node, ast.Call)
             and getattr(node.func, "id", None) == "CIFConfig"]
    (kw,) = [c for c in calls if c.get("vocab_size") == 24]
    want = jcif.CIFConfig(**kw)
    got = multichip.streaming_config()
    assert (want.embed_dim, want.ffn_dim, want.encoder_heads) == (16, 32, 2)
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
