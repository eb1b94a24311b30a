"""The kernels above the widths' old maxima (D 1024, head dim 128, 64
conv-pos channels a group), on the CPU.

The wrappers take D 1280 and 2048 (FFN, LN-FFN), D_in / D_out 1280
(linear-res), head dims 160 and 256 (MHA, Emformer attention) and 96 and
128 channels a group; their width checks accept them.  The plain versions
are held to the JAX package's functions there at dropout 0 in fp32, inputs
made from a numpy seed: ln_ffn_res_reference / ffn_reference and their
VJPs (XLA), attend's (XLA), the linear-res kernel and the grouped
attention kernel in Pallas interpret mode, and the grouped convolution's
weight VJP; atol / rtol 1e-5 (weights of 1 / sqrt(D)).  Then the
algorithms of the kernels that run there, written out in torch as the CUDA
code computes them, on the buffers a C entry is handed, against the plain
versions (atol / rtol 1e-5, dropout 0 and 0.1 with the kernels' Philox
offsets): the LN row passes that walk a row 32 columns a lane at a time
(ffn.cuh ln_rows_wide_kernel, ln_ffn_bwd.cu ln_bwd_rows_wide_kernel), the
wide MHA kernels (mha.cu: the softmax's max, sum and output passes, the
backward's row pass into dS and the dropped probabilities and its key-row
pass) and the wide grouped-attention kernels (emformer_attn.cu: the
segment units, the backward's unit pass into `probs`, the per-slot dK / dV
sums through `slot_column` and the ordered sum of the groups' partials
into key rows).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.nn import attention as jattn  # noqa: E402
from simulst_tpu.nn import conv as jconv  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import AttnGeom as JGeom  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import \
    emformer_grouped_attention as j_grouped  # noqa: E402
from simulst_tpu.ops.ffn_pallas import (ffn_reference,  # noqa: E402
                                        ln_ffn_res_reference)
from simulst_tpu.ops.linear_res_pallas import fused_linear_drop_res  # noqa: E402
from simulst_tpu_torch.ops import conv_pos as tconv  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.ops import ffn as tffn  # noqa: E402
from simulst_tpu_torch.ops import linear_res as tlr  # noqa: E402
from simulst_tpu_torch.ops import mha as tmha  # noqa: E402
from simulst_tpu_torch.ops.philox import keep_threshold, philox_bits  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
FFN_WIDE = [(1280, 64), (2048, 32)]        # (D, hidden)
HEAD_DIMS_WIDE = [160, 256]
CHANNELS_WIDE = [96, 128]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _jax_vjp(fn, arrays, dy):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the width checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,hidden", FFN_WIDE)
def test_checks_take_the_wide_widths(d, hidden):
    """D 1280 / 2048, D_in and D_out 1280, head dims 160 / 256 (on one and
    several heads), 96 / 128 channels a group: taken, and the grouped
    attention's wide blocks fit the card's shared memory at
    s2t_emformer_s's geometry."""
    tffn.check_widths("fused_ffn", d, hidden)
    assert tffn.padded_widths(d, hidden) == (d, tffn.padded_widths(
        d, hidden)[1])
    tlr.check_widths("fused_linear_res", 1280, 1280)
    tlr.check_widths("fused_linear_res", 1280, d)
    geom = tattn.AttnGeom(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8,
                          num_heads=4)
    for hd in HEAD_DIMS_WIDE:
        for heads in (1, 4, 8):
            assert tmha.check_head_dim("fused_mha", hd * heads, heads) == hd
        for backward in (False, True):
            unit, smem = tattn._fitting_unit("attn", geom, hd, backward)
            assert smem <= tattn.SMEM_LIMIT and unit.acc_features == 0
    for cg in CHANNELS_WIDE:
        assert tconv.check_channels("convpos_wgrad", cg * 16, 16) == cg
        assert tconv.padded_channels(cg) == cg


# ---------------------------------------------------------------------------
# the plain versions vs JAX's functions at the wide widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,hidden", FFN_WIDE)
def test_ffn_plain_versions_match_jax_above_d_1024(d, hidden):
    """ln_ffn_res_plain / ffn_plain and their backwards vs JAX's
    ln_ffn_res_reference / ffn_reference and jax.vjp of them, gelu,
    dropout 0."""
    rng = np.random.RandomState(d)
    x, dy = _rand(rng, 6, d), _rand(rng, 6, d)
    ws = [1 + _rand(rng, d, scale=0.1), _rand(rng, d, scale=0.1),
          _rand(rng, d, hidden, scale=d ** -0.5), _rand(rng, hidden, scale=0.1),
          _rand(rng, hidden, d, scale=d ** -0.5), _rand(rng, d, scale=0.1)]
    tt = [torch.from_numpy(a) for a in [x] + ws + [dy]]
    want, grads = _jax_vjp(lambda *a: ln_ffn_res_reference(*a, None, None),
                           [x] + ws, dy)
    _close(tffn.ln_ffn_res_plain(*tt[:7]), want)
    got = tffn.ln_ffn_res_plain_backward(*tt[:6], tt[7])
    for g, w in zip(got, grads[:6]):     # dx, dg, db, dw1, db1, dw2
        _close(g, w)
    _close(got[6], grads[6])
    want, grads = _jax_vjp(lambda *a: ffn_reference(*a, None, None),
                           [x] + ws[2:], dy)
    _close(tffn.ffn_plain(tt[0], *tt[3:7]), want)
    for g, w in zip(tffn.ffn_plain_backward(tt[0], *tt[3:6], tt[7]), grads):
        _close(g, w)


def test_linear_res_plain_versions_match_jax_at_d_1280():
    """linear_res_plain and its backward vs the JAX package's
    fused_linear_drop_res in Pallas interpret mode (and jax.vjp of it) at
    D_in = D_out = 1280, with the Emformer gate, dropout 0."""
    rng = np.random.RandomState(1280)
    h, dy = _rand(rng, 12, 1280), _rand(rng, 12, 1280)
    w = _rand(rng, 1280, 1280, scale=1280 ** -0.5)
    b, res = _rand(rng, 1280), _rand(rng, 12, 1280)
    want, grads = _jax_vjp(lambda h, w, b, r: fused_linear_drop_res(
        h, w, b, r, jnp.zeros((1,), jnp.int32), period=6, res_rows=4,
        interpret=True), [h, w, b, res], dy)
    th, tw, tb, tr, tdy = (torch.from_numpy(a) for a in (h, w, b, res, dy))
    _close(tlr.linear_res_plain(th, tw, tb, tr, 6, 4), want)
    for g, w_ in zip(tlr.linear_res_plain_backward(th, tw, tdy, 6, 4),
                     grads[:3]):
        _close(g, w_)


@pytest.mark.parametrize("hd", HEAD_DIMS_WIDE)
@pytest.mark.parametrize("causal", [False, True])
def test_mha_plain_versions_match_jax_above_head_dim_128(hd, causal):
    """mha_plain and its backward vs JAX's attend (XLA) and jax.vjp of it,
    2 heads, a ragged key mask, dropout 0."""
    heads, d = 2, 2 * hd
    rng = np.random.RandomState(hd + causal)
    q, dout = _rand(rng, 2, 5, d), _rand(rng, 2, 5, d)
    k, v = _rand(rng, 2, 5, d), _rand(rng, 2, 5, d)
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
    _close(tmha.mha_plain(tq, tk, tv, km, heads, causal), want)
    for g, w in zip(tmha.mha_plain_backward(tq, tk, tv, km, tdo, heads,
                                            causal), grads):
        _close(g, w)


@pytest.mark.parametrize("hd", HEAD_DIMS_WIDE)
def test_grouped_attention_plain_versions_match_jax_above_head_dim_128(hd):
    """grouped_attention_plain and its backward vs the JAX package's
    emformer_grouped_attention in Pallas interpret mode (and jax.vjp of
    it), 2 heads, a ragged length, dropout 0."""
    geom = tattn.AttnGeom(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                          num_heads=2)
    d = 2 * hd
    rng = np.random.RandomState(hd)
    q3, dout = (_rand(rng, 2, geom.ng, geom.nq, d) for _ in range(2))
    k, v = (_rand(rng, 2, geom.tk, d) for _ in range(2))
    lengths = np.array([32, 21], np.int32)
    jgeom = JGeom(**geom._asdict())
    want, grads = _jax_vjp(lambda q, k, v: j_grouped(
        q, k, v, jnp.asarray(lengths), jnp.zeros((1,), jnp.int32), None,
        jgeom, 0.0, True), [q3, k, v], dout)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q3, k, v, dout))
    tl = torch.from_numpy(lengths)
    _close(tattn.grouped_attention_plain(tq, tk, tv, tl, geom), want)
    for g, w in zip(tattn.grouped_attention_plain_backward(tq, tk, tv, tl,
                                                           tdo, geom),
                    grads):
        _close(g, w)


@pytest.mark.parametrize("cg", CHANNELS_WIDE)
def test_convpos_wgrad_plain_matches_jax_above_64_channels(cg):
    """convpos_wgrad_plain at 96 and 128 channels a group (two groups) vs
    jax.vjp of the JAX package's grouped convolution (XLA) in its weight,
    16 taps."""
    b, t, taps, groups = 2, 12, 16, 2
    d = cg * groups
    rng = np.random.RandomState(cg)
    xp, dy = _rand(rng, b, t + taps - 1, d), _rand(rng, b, t, d)
    w = _rand(rng, taps, cg, d)
    _, vjp = jax.vjp(lambda w: jconv._conv1d(jnp.asarray(xp), w, 1, groups),
                     jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(dy))[0])      # (K, D / groups, D)
    got = tconv.convpos_wgrad_plain(torch.from_numpy(xp),
                                    torch.from_numpy(dy), taps, groups)
    _close(got, np.transpose(want, (2, 1, 0)))


# ---------------------------------------------------------------------------
# the wide kernels' algorithms, written out in torch
# ---------------------------------------------------------------------------

def _mult(seed, rate, offsets, stream=0):
    """The kernels' dropout multiplier at element `offsets` (int64)."""
    if rate == 0.0:
        return torch.ones(offsets.shape)
    keep = philox_bits(seed, offsets, stream) < keep_threshold(rate)
    return keep.float() / (1.0 - rate)


def _lane_sums(x, d_real=None):
    """A warp's sum of each row: lane l adds columns l, l + 32, ... below
    d_real in order, then the lanes' sums (order aside, the kernels'
    ranges)."""
    cols = x.shape[1] if d_real is None else d_real
    return x[:, :cols].sum(1, keepdim=True)


def _ln_rows_wide(x, ln_g, ln_b, d_real):
    """ln_rows_wide_kernel on padded rows: the mean over every column
    (padding is zero) / d_real, the centred squares over the real columns,
    then (x - mean) inv g + b for every column; and (mean, inv)."""
    mean = _lane_sums(x) / d_real
    inv = torch.rsqrt(_lane_sums((x - mean) ** 2, d_real) / d_real + 1e-5)
    return (x - mean) * inv * ln_g + ln_b, mean, inv


def _ln_bwd_rows_wide(x, ln_g, mean, inv, dn, dy, d_real):
    """ln_bwd_rows_wide_kernel: the two sums over every column, then dx and
    dn xhat."""
    xh = (x - mean) * inv
    gg = dn * ln_g
    m1 = _lane_sums(gg) / d_real
    m2 = _lane_sums(gg * xh) / d_real
    return inv * (gg - m1 - xh * m2) + dy, dn * xh


@pytest.mark.parametrize("d,d_real", [(1280, 1280), (2048, 2000)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_ln_row_passes_match_the_plain_ln_ffn(d, d_real, rate):
    """The LN-FFN forward and backward with their LN rows as the walking
    kernels compute them (on rows zero-padded from d_real to d, zero LN
    parameters there) and the products and masks of the C entry's
    contract: sliced back, equal to ln_ffn_res_plain and its backward."""
    hidden = 64
    rng = np.random.RandomState(d_real)
    x, dy = (torch.from_numpy(_rand(rng, 7, d_real)) for _ in range(2))
    ln_g = torch.from_numpy(1 + _rand(rng, d_real, scale=0.1))
    ln_b = torch.from_numpy(_rand(rng, d_real, scale=0.1))
    w1 = torch.from_numpy(_rand(rng, d_real, hidden, scale=d_real ** -0.5))
    b1 = torch.from_numpy(_rand(rng, hidden, scale=0.1))
    w2 = torch.from_numpy(_rand(rng, hidden, d_real, scale=d_real ** -0.5))
    b2 = torch.from_numpy(_rand(rng, d_real, scale=0.1))
    cfg = ("gelu", rate, rate, 31)
    pad = lambda t, *w: tffn._build.padded(t, *w)  # noqa: E731
    xp, dyp, gp, bp = pad(x, d), pad(dy, d), pad(ln_g, d), pad(ln_b, d)
    w1p, w2p, b2p = pad(w1, d, hidden), pad(w2, hidden, d), pad(b2, d)
    rows = torch.arange(7)[:, None]
    m_a = _mult(31, rate, rows * hidden + torch.arange(hidden), 0)
    m_o = _mult(31, rate, rows * d_real + torch.arange(d), 1)
    xn, mean, inv = _ln_rows_wide(xp, gp, bp, d_real)
    u = xn @ w1p + b1
    h = tffn._act("gelu", u) * m_a
    y = (h @ w2p + b2p) * m_o + xp
    _close(y[:, :d_real], tffn.ln_ffn_res_plain(x, ln_g, ln_b, w1, b1, w2, b2,
                                                 *cfg))
    g = dyp * m_o
    du = (g @ w2p.T) * tffn._act_grad("gelu", u) * m_a
    dx, dnx = _ln_bwd_rows_wide(xp, gp, mean, inv, du @ w1p.T, dyp, d_real)
    want = tffn.ln_ffn_res_plain_backward(x, ln_g, ln_b, w1, b1, w2, dy, *cfg)
    _close(dx[:, :d_real], want[0])
    _close(dnx.sum(0)[:d_real], want[1])
    assert not dnx[:, d_real:].any()   # dgamma's pads (dx's are sliced)


def _mha_wide_fwd(q, k, v, kmask, heads, causal, rate, seed):
    """mha_fwd_wide_kernel: per (b, h, q) the scores' max, then their sum,
    then out = sum_k round(exp(s - max) / sum mult) v_k and lse = max +
    log sum (+inf and zeros for a row that sees no key)."""
    b, tq, d = q.shape
    tk, hd = k.shape[1], d // heads
    split = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2)  # noqa: E731
    s = split(q) @ split(k).transpose(-1, -2) / hd ** 0.5
    vis = (kmask != 0)[:, None, None, :].expand(b, heads, tq, tk)
    if causal:
        vis = vis & torch.ones(tq, tk, dtype=torch.bool).tril()
    s = torch.where(vis, s, torch.tensor(-float("inf")))
    m = s.amax(-1, keepdim=True)
    live = m > -float("inf")
    e = torch.where(vis, torch.exp(s - torch.where(live, m, 0.0)), 0.0)
    l = e.sum(-1, keepdim=True)
    off = ((torch.arange(b)[:, None, None, None] * heads
            + torch.arange(heads)[None, :, None, None]) * tq
           + torch.arange(tq)[None, None, :, None]) * tk \
        + torch.arange(tk)[None, None, None, :]
    p = torch.where(live, e / torch.where(live, l, 1.0), 0.0) \
        * _mult(seed, rate, off)
    out = (p @ split(v)).transpose(1, 2).reshape(b, tq, d)
    lse = torch.where(live, m + torch.log(torch.where(live, l, 1.0)),
                      torch.tensor(float("inf")))[..., 0]
    return out, lse, off


def _mha_wide_bwd(q, k, v, kmask, out, lse, dout, heads, causal, rate, seed):
    """mha_bwd_delta_wide_kernel, mha_bwd_rows_wide_kernel (p = exp(s -
    lse), pd = round(p mult), dS = round(p (dO . v mult - delta) / sqrt
    hd) into the scratch, dQ = dS K) and mha_bwd_keys_wide_kernel (dK =
    dS^T Q and dV = pd^T dO over the query rows)."""
    b, tq, d = q.shape
    tk, hd = k.shape[1], d // heads
    split = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2)  # noqa: E731
    merge = lambda t: t.transpose(1, 2).reshape(b, -1, d)  # noqa: E731
    delta = (split(dout) * split(out)).sum(-1, keepdim=True)
    s = split(q) @ split(k).transpose(-1, -2) / hd ** 0.5
    vis = (kmask != 0)[:, None, None, :].expand(b, heads, tq, tk)
    if causal:
        vis = vis & torch.ones(tq, tk, dtype=torch.bool).tril()
    p = torch.where(vis, torch.exp(s - torch.where(
        torch.isinf(lse), 0.0, lse)[..., None]), 0.0)
    _, _, off = _mha_wide_fwd(q, k, v, kmask, heads, causal, 0.0, seed)
    mult = _mult(seed, rate, off)
    dp = split(dout) @ split(v).transpose(-1, -2)
    pd = p * mult
    ds = p * (dp * mult - delta) / hd ** 0.5
    return merge(ds @ split(k)), merge(ds.transpose(-1, -2) @ split(q)), \
        merge(pd.transpose(-1, -2) @ split(dout))


@pytest.mark.parametrize("hd", HEAD_DIMS_WIDE)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_mha_kernels_match_the_plain_versions(hd, rate):
    """The wide MHA forward and backward as the kernels compute them, 2
    heads, causal and not, a ragged key mask and a row that sees no key:
    equal to mha_plain and its backward."""
    heads, d = 2, 2 * hd
    rng = np.random.RandomState(hd + int(10 * rate))
    q, dout = (torch.from_numpy(_rand(rng, 3, 6, d)) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, 3, 9, d)) for _ in range(2))
    kmask = torch.tensor([[1] * 9, [1] * 5 + [0] * 4, [0] * 9],
                         dtype=torch.int32)
    for causal in (False, True):
        args = (q, k, v, kmask, heads, causal, rate, 5)
        out, lse, _ = _mha_wide_fwd(*args)
        _close(out, tmha.mha_plain(*args))
        assert torch.isinf(lse[2]).all()
        got = _mha_wide_bwd(q, k, v, kmask, out, lse, dout, *args[4:])
        for g, w in zip(got, tmha.mha_plain_backward(q, k, v, kmask, dout,
                                                     *args[4:])):
            _close(g, w)


class _Geom:
    """emformer_attn.cu's Geom of an AttnGeom."""

    def __init__(self, geom, dim):
        for f in ("seg", "lc", "rc", "max_mem", "G", "n", "ng", "nq", "tk",
                  "m_slots", "ctx", "U"):
            setattr(self, f, getattr(geom, f))
        self.heads, self.dim = geom.num_heads, dim
        self.hd = dim // self.heads
        self.R = self.rc + self.seg + 1
        self.C = self.max_mem + self.rc + self.lc + self.seg


def _slot_to_row(g, grp, c):
    utt0 = g.m_slots + g.G * g.rc
    if c < g.m_slots:
        js = grp * g.G - g.max_mem + c
        return js if 0 <= js <= g.n - 2 else -1
    if c < utt0:
        return (g.n - 1) + grp * g.G * g.rc + (c - g.m_slots)
    f = grp * g.G * g.seg - g.lc + (c - utt0)
    return (g.n - 1) + g.n * g.rc + f if 0 <= f < g.U else -1


def _unit_slot(g, i, j):
    if j < g.max_mem:
        return i + j
    j -= g.max_mem
    if j < g.rc:
        return g.m_slots + i * g.rc + j
    return g.m_slots + g.G * g.rc + i * g.seg + (j - g.rc)


def _unit_row(g, i, r):
    if r < g.rc:
        return i * g.rc + r
    if r < g.rc + g.seg:
        return g.G * g.rc + i * g.seg + (r - g.rc)
    return g.G * (g.rc + g.seg) + i


def _slot_column(g, i, c):
    """emformer_attn.cu slot_column: the inverse of _unit_slot."""
    if c < g.m_slots:
        return c - i if 0 <= c - i < g.max_mem else -1
    rc0 = g.m_slots + i * g.rc
    if c < g.m_slots + g.G * g.rc:
        return g.max_mem + (c - rc0) if rc0 <= c < rc0 + g.rc else -1
    u0 = g.m_slots + g.G * g.rc + i * g.seg
    return g.max_mem + g.rc + (c - u0) if u0 <= c < u0 + g.lc + g.seg else -1


def _unit(g, b, grp, i, length):
    """unit_columns (ungated) and unit_visible: (slots, rows, (R, C)
    visibility)."""
    utt0 = g.m_slots + g.G * g.rc
    frame0 = grp * g.G * g.seg - g.lc
    slots, rows, ok = [], [], []
    for j in range(g.C):
        slot = _unit_slot(g, i, j)
        row = _slot_to_row(g, grp, slot)
        own_rc = g.max_mem <= j < g.max_mem + g.rc
        ok.append(own_rc or (row >= 0 and (
            j < g.max_mem or frame0 + (slot - utt0) < length)))
        slots.append(slot)
        rows.append(row)
    vis = torch.tensor(ok)[None, :].repeat(g.R, 1)
    vis[g.R - 1, :g.max_mem] = False     # the summary row sees no memory
    return slots, rows, vis


def _grouped_wide(q3, k, v, dout, lengths, geom, rate, seed):
    """grouped_attn_wide_kernel, grouped_attn_wide_bwd_kernel (per unit),
    grouped_attn_wide_dkv_kernel (per group: each context slot's dK / dV
    over the units holding it, through slot_column) and the ordered sum of
    the groups' partials into key rows."""
    b_, _, _, dim = q3.shape
    g = _Geom(geom, dim)
    hd, scale = g.hd, g.hd ** -0.5
    keep = 1.0 / (1.0 - rate) if rate else 1.0
    out, dq = torch.zeros_like(q3), torch.zeros_like(q3)
    part_k = torch.zeros(b_, g.ng, g.ctx, dim)
    part_v = torch.zeros(b_, g.ng, g.ctx, dim)
    for b in range(b_):
        for grp in range(g.ng):
            for h in range(g.heads):
                fs = slice(h * hd, (h + 1) * hd)
                probs = []
                for i in range(g.G):
                    slots, rows, vis = _unit(g, b, grp, i, int(lengths[b]))
                    qr = [_unit_row(g, i, r) for r in range(g.R)]
                    Q, DO = q3[b, grp, qr, fs], dout[b, grp, qr, fs]
                    kr = [max(r, 0) for r in rows]
                    K, V = k[b, kr, fs], v[b, kr, fs]
                    s = torch.where(vis, Q @ K.T * scale, -float("inf"))
                    t = torch.where(vis, DO @ V.T, 0.0)
                    mx = s.amax(1, keepdim=True)
                    live = mx > -float("inf")
                    e = torch.where(vis, torch.exp(s - torch.where(
                        live, mx, 0.0)), 0.0)
                    tot = e.sum(1, keepdim=True)
                    inv = torch.where(live, 1.0 / torch.where(live, tot, 1.0),
                                      0.0)
                    row_base = ((b * g.ng + grp) * g.heads + h) * g.nq
                    off = (torch.tensor(qr)[:, None] + row_base) * g.ctx \
                        + torch.tensor(slots)[None, :]
                    m = (_mult(seed, rate, off) != 0).float() * keep
                    p = e * inv
                    out[b, grp, qr, fs] = (p * m) @ V
                    delta = (t * m * p).sum(1, keepdim=True)
                    ds_q = p * (t * m - delta) * scale
                    lse = torch.where(live, mx + torch.log(torch.where(
                        live, tot, 1.0)), 0.0)
                    pl = torch.where(vis, torch.exp(s - lse), 0.0)
                    pd = torch.where(m != 0, pl * keep, 0.0)
                    ds_k = pl * (t * m - delta) * scale
                    dq[b, grp, qr, fs] = ds_q @ K
                    probs.append((pd, ds_k, qr))
                for c in range(g.ctx):
                    for i, (pd, ds_k, qr) in enumerate(probs):
                        j = _slot_column(g, i, c)
                        if j >= 0:
                            part_k[b, grp, c, fs] += ds_k[:, j] @ \
                                q3[b, grp, qr, fs]
                            part_v[b, grp, c, fs] += pd[:, j] @ \
                                dout[b, grp, qr, fs]
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for b in range(b_):
        for grp in range(g.ng):
            for c in range(g.ctx):
                row = _slot_to_row(g, grp, c)
                if row >= 0:
                    dk[b, row] += part_k[b, grp, c]
                    dv[b, row] += part_v[b, grp, c]
    return out, (dq, dk, dv)


@pytest.mark.parametrize("hd", HEAD_DIMS_WIDE)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_grouped_attention_kernels_match_the_plain_versions(hd, rate):
    """The wide grouped-attention forward and backward as the kernels
    compute them (segment units, slot_column's per-slot dK / dV, the
    groups' partials summed into key rows) at a two-group geometry with a
    ragged length, 2 heads: equal to grouped_attention_plain and its
    backward, dropout masks at the gathered-context offsets."""
    geom = tattn.AttnGeom(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                          num_heads=2)
    d = 2 * hd
    rng = np.random.RandomState(hd + int(10 * rate))
    q3, dout = (torch.from_numpy(_rand(rng, 2, geom.ng, geom.nq, d))
                for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, 2, geom.tk, d)) for _ in range(2))
    lengths = torch.tensor([32, 21], dtype=torch.int32)
    out, grads = _grouped_wide(q3, k, v, dout, lengths, geom, rate, 9)
    _close(out, tattn.grouped_attention_plain(q3, k, v, lengths, geom, rate,
                                              9))
    for g, w in zip(grads, tattn.grouped_attention_plain_backward(
            q3, k, v, lengths, dout, geom, rate, 9)):
        _close(g, w)
