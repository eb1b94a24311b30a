"""The bf16 grouped-attention backward and the bf16 linear-res forward in
simulst_tpu_torch vs the JAX package, on the CPU, and the plans that
send them to the tensor cores on the card.

On the card the grouped attention's bf16 backward runs on the tensor
cores (csrc/emformer_attn_bwd.cu) and the linear-res forward's bf16
tiled paths on `wgmma_product`; tests/test_torch_port_cuda.py holds them
to their plain versions there.  Here:

- the plain bf16 grouped-attention backward (`grouped_attention_plain_
  backward`) against jax.vjp of the JAX package's XLA grouped attention
  in bf16 and fp32 (nn/emformer.py `_grouped_attention`'s gathered-
  context branch, the core before out_proj, written out below from the
  package's own `_group_gather_indices`, `_group_row_seg`,
  `_attn_softmax` and `neg_inf`), ungated and with the example-id gate,
  head dims 64 and 50, rate 0: dq at BF16_TOL (chip_smoke's: atol 3e-2,
  rtol 1e-2), dk and dv within BF16_GRAD_RTOL (2e-2) of their largest
  entry of JAX's bf16 gradient and no further from JAX's fp32 than
  BF16_RATIO (2) times JAX's own bf16 (JAX rounds its scores to bf16 and
  sums the context gradients into key rows in bf16; the port keeps fp32
  there, as the Pallas kernel does);
- the plain bf16 linear-res forward against the JAX package's XLA path
  (`linear`, then the residual on gated rows) in bf16, at BF16_TOL,
  gated and ungated, D 256 and 200;
- the tensor-core backward's algorithm written out in torch (the segment
  units walked in order, each row's softmax statistics from four column
  quarters, dK / dV of the memory slots held for the group, the
  utterance slots in a ring of lc + seg written out at their last unit,
  the rc slots at once, then the ordered sum of the groups' partials)
  against the plain fp32 backward at 1e-5, with dropout;
- `bwd_plan`, `tc_smem_bytes` and the linear-res
  forward's bf16 route (`fwd_plan`, `fwd_uses_tensor_cores`).

Tiny shapes (B 2, one or two groups of G 2-4, D 64-128), one torch
thread.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.nn import emformer as jemf  # noqa: E402
from simulst_tpu.nn.core import linear as j_linear  # noqa: E402
from simulst_tpu.nn.core import neg_inf  # noqa: E402
from simulst_tpu_torch.ops import emformer_attn as tattn  # noqa: E402
from simulst_tpu_torch.ops import linear_res as tlr  # noqa: E402
from simulst_tpu_torch.ops.philox import keep_threshold, philox_bits  # noqa: E402

BF16_TOL = dict(atol=3e-2, rtol=1e-2)   # chip_smoke.BF16_TOL
BF16_GRAD_RTOL = 2e-2
BF16_RATIO = 2.0
# one group of G 2: seg 8, lc 16, rc 4, three memory slots
GEOM = dict(U=16, seg=8, lc=16, rc=4, max_mem=3, G=2)
# s2t_emformer_s's unit and group geometry
ASR = dict(U=256, seg=16, lc=32, rc=8, max_mem=5, G=8, num_heads=4)


def _bf16(rng, *shape, scale=1.0):
    """A seeded bf16 array as numpy fp32 (its values exact in bf16)."""
    a = (rng.randn(*shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _jax_grouped_core(q3, k, v, lengths, geom, gate):
    """nn/emformer.py `_grouped_attention`'s XLA branch from the gather to
    the merged heads (its out_proj input), in the inputs' dtype."""
    b, ng, nq, d = q3.shape
    h = geom.num_heads
    hd = d // h
    idx_np, valid_np, utt_col_np, allowed_np = jemf._group_gather_indices(
        geom.U, geom.seg, geom.lc, geom.rc, geom.max_mem, geom.G)
    idx = jnp.asarray(idx_np)
    ctx = idx.shape[1]
    k_ctx = jnp.take(k, idx.reshape(-1), axis=1).reshape(b, ng, ctx, d)
    v_ctx = jnp.take(v, idx.reshape(-1), axis=1).reshape(b, ng, ctx, d)
    valid = jnp.asarray(valid_np)[None]
    utt_col = jnp.asarray(utt_col_np)
    if gate is None:
        in_len = (utt_col[None] < lengths[:, None, None]) | (utt_col[None] < 0)
        key_valid = valid & in_len
        eid_ok = None
    else:
        kid, seg_eid = gate
        key_valid = jnp.broadcast_to(valid, (b, ng, ctx))
        eid_k = jnp.take(kid, idx.reshape(-1), axis=1).reshape(b, ng, ctx)
        gi = (np.arange(ng)[:, None] * geom.G
              + jemf._group_row_seg(geom.seg, geom.rc, geom.G)[None])
        qid = jnp.take(seg_eid, jnp.asarray(gi.reshape(-1)),
                       axis=1).reshape(b, ng, nq)
        eid_ok = eid_k[:, :, None, :] == qid[..., None]
    qh = q3.reshape(b, ng, nq, h, hd).transpose(0, 1, 3, 2, 4) * (hd ** -0.5)
    kh = k_ctx.reshape(b, ng, ctx, h, hd).transpose(0, 1, 3, 2, 4)
    vh = v_ctx.reshape(b, ng, ctx, h, hd).transpose(0, 1, 3, 2, 4)
    scores = jnp.einsum("bnhqd,bnhkd->bnhqk", qh, kh).astype(jnp.float32)
    ni = neg_inf(q3.dtype)
    scores = jnp.where(key_valid[:, :, None, None, :], scores, ni)
    scores = jnp.where(jnp.asarray(allowed_np)[None, None, None], scores, ni)
    if eid_ok is not None:
        scores = jnp.where(eid_ok[:, :, None], scores, ni)
    probs = jemf._attn_softmax(scores).astype(q3.dtype)
    out = jnp.einsum("bnhqk,bnhkd->bnhqd", probs, vh)
    return out.transpose(0, 1, 3, 2, 4).reshape(b, ng, nq, d)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("hd", [64, 50])
def test_grouped_attention_bf16_backward_matches_jax_xla(hd, gated):
    """dq, dk, dv of the port's plain bf16 backward against jax.vjp of the
    JAX package's XLA grouped attention in bf16 and fp32, rate 0, 2 heads
    (D 128, and D 100 at head dim 50), one group of G 2, one example's
    length ragged; gated: random example ids of the key rows and the
    segments (rows that see no key give zeros on both sides)."""
    geom = tattn.AttnGeom(**GEOM, num_heads=2)
    d = 2 * hd
    rng = np.random.RandomState(hd + gated)
    q3, dout = (_bf16(rng, 2, geom.ng, geom.nq, d) for _ in range(2))
    k, v = (_bf16(rng, 2, geom.tk, d) for _ in range(2))
    lengths = np.array([geom.U, 11], np.int32)
    gate = None
    if gated:
        lengths[:] = geom.U   # packed rows are full
        gate = tuple(rng.randint(0, 2, shape).astype(np.int32)
                     for shape in ((2, geom.tk), (2, geom.n)))
    jgate = None if gate is None else tuple(map(jnp.asarray, gate))

    def fn(*a):
        return _jax_grouped_core(*a, jnp.asarray(lengths), geom, jgate)
    _, vjp = jax.vjp(fn, *map(_j, (q3, k, v)))
    want = vjp(_j(dout))
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q3, k, v)))
    want_f32 = vjp(jnp.asarray(dout))
    got = tattn.grouped_attention_plain_backward(
        _t(q3), _t(k), _t(v), torch.from_numpy(lengths), _t(dout), geom,
        gate=None if gate is None else tattn.EidGate(
            *map(torch.from_numpy, gate)))
    for i, (name, a, b, c) in enumerate(zip("qkv", got, want, want_f32)):
        a = a.float().numpy()
        b, c = np.asarray(b.astype(jnp.float32)), np.asarray(c)
        if i == 0:
            np.testing.assert_allclose(a, b, **BF16_TOL, err_msg="dq")
            continue
        assert np.abs(a - b).max() <= BF16_GRAD_RTOL * np.abs(b).max(), name
        assert np.abs(a - c).max() <= BF16_RATIO * np.abs(b - c).max(), name


@pytest.mark.parametrize("d", [256, 200])
@pytest.mark.parametrize("period,res_rows", [(0, 0), (7, 5)])
def test_linear_res_bf16_forward_matches_jax_xla(period, res_rows, d):
    """The port's plain bf16 linear-res forward against the JAX package's
    XLA path in bf16 (`linear`, then the residual on rows with row % period
    < res_rows), 40 rows, gated and ungated, D 256 and the padded D 200,
    at BF16_TOL."""
    rng = np.random.RandomState(d + period)
    rows = 40
    h, res = _bf16(rng, rows, d), _bf16(rng, rows, d)
    w, b = _bf16(rng, d, d, scale=d ** -0.5), _bf16(rng, d, scale=0.02)
    gate = (np.arange(rows)[:, None] % period < res_rows) if period else \
        np.ones((rows, 1), bool)
    y = j_linear({"weight": _j(w), "bias": _j(b)}, _j(h))
    want = np.asarray(jnp.where(gate, y + _j(res), y).astype(jnp.float32))
    got = tlr.linear_res_plain(_t(h), _t(w), _t(b), _t(res), period,
                               res_rows)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


# ---------------------------------------------------------------------------
# the tensor-core backward's algorithm, written out in torch
# ---------------------------------------------------------------------------

def _mult(seed, rate, offsets):
    """The kernels' dropout multiplier at element `offsets` (int64)."""
    if rate == 0.0:
        return torch.ones(offsets.shape)
    keep = philox_bits(seed, offsets, 0) < keep_threshold(rate)
    return keep.float() / (1.0 - rate)


def _maps(geom):
    """emformer_attn.cuh's slot_to_row, unit_slot and unit_row."""
    n, G, rc, seg, mm = geom.n, geom.G, geom.rc, geom.seg, geom.max_mem
    utt0 = geom.m_slots + G * rc

    def slot_to_row(grp, c):
        if c < geom.m_slots:
            js = grp * G - mm + c
            return js if 0 <= js <= n - 2 else -1
        if c < utt0:
            return (n - 1) + grp * G * rc + (c - geom.m_slots)
        f = grp * G * seg - geom.lc + (c - utt0)
        return (n - 1) + n * rc + f if 0 <= f < geom.U else -1

    def unit_slot(i, j):
        if j < mm:
            return i + j
        if j < mm + rc:
            return geom.m_slots + i * rc + j - mm
        return utt0 + i * seg + (j - mm - rc)

    def unit_row(i, r):
        if r < rc:
            return i * rc + r
        if r < rc + seg:
            return G * rc + i * seg + (r - rc)
        return G * (rc + seg) + i

    def slot_exclusive(grp, c):
        if c < geom.m_slots:
            js = grp * G - mm + c
            return 0 <= js <= n - 2 and (grp == 0 or js >= grp * G - 1) \
                and (grp == geom.ng - 1 or js < (grp + 1) * G - mm)
        if c < utt0:
            return True
        u = c - utt0
        f = grp * G * seg - geom.lc + u
        return 0 <= f < geom.U and (grp == 0 or u >= geom.lc) \
            and (grp == geom.ng - 1 or u < G * seg)
    return slot_to_row, unit_slot, unit_row, slot_exclusive


def _tc_backward(q3, k, v, lengths, dout, geom, rate, seed):
    """grouped_attn_bwd_tc_kernel and the ordered sum of the rows several
    groups' contexts hold (or none), fp32: (dq, dk, dv).  A complete slot
    goes to its key row directly where `slot_exclusive`, else to the
    group's partials; rows neither writes stay NaN."""
    b_, ng, nq, dim = q3.shape
    h_, G, seg, rc, mm = geom.num_heads, geom.G, geom.seg, geom.rc, \
        geom.max_mem
    hd = dim // h_
    scale = hd ** -0.5
    R, C = rc + seg + 1, mm + rc + geom.lc + seg
    cp = -(-C // 64) * 64
    quarter = cp // 4
    ring = geom.lc + seg
    utt0 = geom.m_slots + G * rc
    slot_to_row, unit_slot, unit_row, slot_exclusive = _maps(geom)
    dq = torch.zeros_like(q3)
    dk, dv = torch.full_like(k, float("nan")), torch.full_like(v, float("nan"))
    part_k = torch.zeros(b_, ng, geom.ctx, dim)
    part_v = torch.zeros(b_, ng, geom.ctx, dim)
    for b in range(b_):
        for grp in range(ng):
            for head in range(h_):
                fs = slice(head * hd, (head + 1) * hd)
                acc_k = torch.zeros(geom.m_slots + ring, hd)
                acc_v = torch.zeros(geom.m_slots + ring, hd)
                for i in range(G):
                    slots = [unit_slot(i, j) for j in range(C)]
                    krow = [slot_to_row(grp, s) for s in slots]
                    frame0 = grp * G * seg - geom.lc
                    ok = [(mm <= j < mm + rc) or (krow[j] >= 0 and (
                        j < mm or frame0 + slots[j] - utt0 < int(lengths[b])))
                        for j in range(C)]
                    vis = torch.zeros(R, cp, dtype=torch.bool)
                    vis[:, :C] = torch.tensor(ok)[None]
                    vis[R - 1, :mm] = False
                    qr = [unit_row(i, r) for r in range(R)]
                    Q, DO = q3[b, grp, qr, fs], dout[b, grp, qr, fs]
                    K, V = torch.zeros(cp, hd), torch.zeros(cp, hd)
                    for j in range(C):
                        if krow[j] >= 0:
                            K[j], V[j] = k[b, krow[j], fs], v[b, krow[j], fs]
                    s = torch.where(vis, Q @ K.T * scale, -float("inf"))
                    row_base = ((b * ng + grp) * h_ + head) * nq
                    off = (torch.tensor(qr)[:, None] + row_base) * geom.ctx \
                        + torch.tensor(slots + [0] * (cp - C))[None]
                    m = torch.where(vis, _mult(seed, rate, off), 0.0)
                    dp = torch.where(vis, DO @ V.T, 0.0) * m
                    # each quarter's max, sum of e and of e dp m, combined
                    mx, e, sums, ts = [], [], [], []
                    for q in range(4):
                        cs = slice(q * quarter, (q + 1) * quarter)
                        mq = s[:, cs].amax(1, keepdim=True)
                        eq = torch.where(vis[:, cs], torch.exp(
                            s[:, cs] - torch.where(mq > -float("inf"), mq,
                                                   0.0)), 0.0)
                        mx.append(mq)
                        e.append(eq)
                        sums.append(eq.sum(1, keepdim=True))
                        ts.append((eq * dp[:, cs]).sum(1, keepdim=True))
                    big = torch.stack(mx).amax(0)
                    live = big > -float("inf")
                    w = [torch.where(mq > -float("inf"), torch.exp(
                        mq - torch.where(live, big, 0.0)), 0.0) for mq in mx]
                    tot = sum(sq * wq for sq, wq in zip(sums, w))
                    inv = torch.where(live, 1.0 / torch.where(live, tot, 1.0),
                                      0.0)
                    delta = sum(tq * wq for tq, wq in zip(ts, w)) * inv
                    p = torch.cat([eq * wq * inv for eq, wq in zip(e, w)], 1)
                    ds = p * (dp - delta) * scale
                    pm = p * m
                    dq[b, grp, qr, fs] = ds @ K
                    dk_u, dv_u = ds.T @ Q, pm.T @ DO
                    def put(slot, gk, gv):
                        if slot_exclusive(grp, slot):
                            row = slot_to_row(grp, slot)
                            dk[b, row, fs], dv[b, row, fs] = gk, gv
                        else:
                            part_k[b, grp, slot, fs] = gk
                            part_v[b, grp, slot, fs] = gv
                    for j in range(C):
                        slot = slots[j]
                        if j < mm:
                            acc_k[slot] += dk_u[j]
                            acc_v[slot] += dv_u[j]
                        elif j < mm + rc:
                            put(slot, dk_u[j], dv_u[j])
                        else:
                            u = slot - utt0
                            pos = geom.m_slots + u % ring
                            acc_k[pos] += dk_u[j]
                            acc_v[pos] += dv_u[j]
                            if i == min(u // seg, G - 1):   # its last unit
                                put(slot, acc_k[pos].clone(),
                                    acc_v[pos].clone())
                                acc_k[pos] = 0.0
                                acc_v[pos] = 0.0
                for c in range(geom.m_slots):
                    put(c, acc_k[c], acc_v[c])
    for b in range(b_):
        for row in range(geom.tk):
            held = [(grp, c) for grp in range(ng) for c in range(geom.ctx)
                    if slot_to_row(grp, c) == row]
            if len(held) == 1:
                continue   # written at its slot
            dk[b, row], dv[b, row] = 0.0, 0.0
            for grp, c in held:
                dk[b, row] += part_k[b, grp, c]
                dv[b, row] += part_v[b, grp, c]
    return dq, dk, dv


# (U, seg, lc, rc, max_mem, G): one group of G 2; two groups of G 4 with lc
# 2 seg (an utterance slot seen by three units); lc not a multiple of seg
# and one memory slot; no memory slot
TC_GEOMS = {"G2": (16, 8, 16, 4, 3, 2), "G4-2groups": (64, 8, 16, 4, 3, 4),
            "lc12-mem1": (48, 8, 12, 4, 1, 3), "mem0": (32, 8, 8, 4, 0, 2)}


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("geom_id", TC_GEOMS)
def test_tensor_core_backward_algorithm_matches_the_plain_backward(geom_id,
                                                                   rate):
    """The bf16 tensor-core backward's algorithm in fp32 (`_tc_backward`:
    the order of its units, its quarter statistics, its ring of open slots
    and the ordered sum) equals grouped_attention_plain_backward at 1e-5,
    2 heads of 8, one example's length ragged, the dropout masks at the
    gathered-context offsets."""
    U, seg, lc, rc, mm, G = TC_GEOMS[geom_id]
    geom = tattn.AttnGeom(U=U, seg=seg, lc=lc, rc=rc, max_mem=mm, G=G,
                          num_heads=2)
    rng = np.random.RandomState(U + G + int(10 * rate))
    q3, dout = (torch.from_numpy((rng.randn(2, geom.ng, geom.nq, 16))
                                 .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, geom.tk, 16).astype(np.float32))
            for _ in range(2))
    lengths = torch.tensor([U, U - seg - 3], dtype=torch.int32)
    got = _tc_backward(q3, k, v, lengths, dout, geom, rate, 5)
    want = tattn.grouped_attention_plain_backward(q3, k, v, lengths, dout,
                                                  geom, rate, 5)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def test_tensor_core_backward_block_at_the_train_shape():
    """The block's shared memory at asr-train's geometry (head dim 64:
    two blocks an SM, half of the units backward's 200 KB) and at head dim
    128 (one), as csrc/emformer_attn_bwd.cu lays it out."""
    geom = tattn.AttnGeom(**ASR)
    sm = 228 * 1024   # an SM's shared memory, 1 KB of it reserved a block
    assert tattn.tc_smem_bytes(geom, 64) == 102656
    assert 2 * (tattn.tc_smem_bytes(geom, 64) + 1024) <= sm
    assert tattn.tc_smem_bytes(geom, 128) == 182528
    assert 2 * (tattn.tc_smem_bytes(geom, 128) + 1024) > sm
    assert tattn.unit_shape(geom, 64).bwd_smem == 199936
    # a padded head dim stages as the next staged width
    assert tattn.tc_smem_bytes(geom, 56) == tattn.tc_smem_bytes(geom, 64)


@pytest.mark.parametrize("case,fields,hd,dtype,plan", [
    ("train", {}, 64, torch.bfloat16, "tensor_cores"),
    ("fp32", {}, 64, torch.float32, "units"),
    ("head dim 128", {}, 128, torch.bfloat16, "tensor_cores"),
    ("head dim 56 (50 padded)", {}, 56, torch.bfloat16, "tensor_cores"),
    ("wide head dim 160", {}, 160, torch.bfloat16, "units"),
    ("G 16", dict(U=512, G=16), 64, torch.bfloat16, "tensor_cores"),
    ("G 16 head dim 128", dict(U=512, G=16), 128, torch.bfloat16,
     "tensor_cores"),
    ("G 7 packed", dict(U=448, G=7), 64, torch.bfloat16, "tensor_cores"),
    ("G 3 packed", dict(U=624, G=3), 64, torch.bfloat16,
     "tensor_cores"),
    ("columns above 128", dict(lc=112, G=2, U=64), 64, torch.bfloat16,
     "units"),
    ("columns 128", dict(lc=96, U=512, G=8), 64, torch.bfloat16,
     "tensor_cores"),
])
def test_bwd_plan(case, fields, hd, dtype, plan):
    """bwd_plan: bf16 up to head dim 128 with the unit's columns at most
    128 once padded on the tensor cores; fp32, wide head dims and wider
    units on the units backward; every shape the units backward takes is
    still taken (`_fitting_unit`)."""
    geom = tattn.AttnGeom(**{**ASR, **fields})
    tattn._fitting_unit(case, geom, hd, backward=True)   # taken, as before
    assert tattn.bwd_plan(geom, hd, dtype) == plan


def test_g16_is_taken_and_g64_refused_as_before():
    """G 16 (436 context slots) is taken in both dtypes; G 64 is refused
    by the units backward's block, in bf16 as in fp32, although the
    tensor-core block would fit: the backward takes what it took."""
    g16 = tattn.AttnGeom(**{**ASR, "U": 512, "G": 16})
    assert g16.ctx == 436
    assert tattn._fitting_unit("g16", g16, 64, backward=True)
    g64 = tattn.AttnGeom(**{**ASR, "U": 1024, "G": 64})
    with pytest.raises(ValueError, match="shared memory"):
        tattn._fitting_unit("g64", g64, 64, backward=True)
    assert tattn.tc_smem_bytes(g64, 64) <= tattn.SMEM_LIMIT


@pytest.mark.parametrize("rows,path,tensor_cores", [
    (1, "rows", False), (40, "rows", False),
    (tlr.TILED_MIN_ROWS - 1, "rows", False),
    (tlr.TILED_MIN_ROWS, "tiled", True), (2304, "tiled", True),
    (3200, "tiled", True), (tlr.WIDE_MIN_ROWS, "wide", True),
    (12800, "wide", True)])
def test_linear_res_forward_bf16_route(rows, path, tensor_cores):
    """The forward's path by rows, the same in both dtypes; in bf16 both
    tiled paths run on the tensor cores, the row kernel and fp32 never."""
    assert tlr.fwd_plan(rows) == path
    assert tlr.fwd_uses_tensor_cores(path, torch.bfloat16) is tensor_cores
    assert tlr.fwd_uses_tensor_cores(path, torch.float32) is False
