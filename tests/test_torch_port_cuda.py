"""simulst_tpu_torch CUDA kernels vs their plain PyTorch versions, on the
card.  Skips without a CUDA device.  Needs neither JAX nor the repo's
conftest, so on a machine with the card and no JAX run it as

    python -m pytest --noconftest tests/test_torch_port_cuda.py

fp32 at the slices' widths (D 256, FFN 2048, 4 heads of 64) with ragged
row counts and lengths; tolerance atol 1e-4, rtol 1e-4 on outputs and
activation gradients, and 1e-4 of the largest entry on weight gradients:
the kernels and the plain versions differ only in the order of the fp32
sums.  The linear-res and MHA forwards run each listed shape on both of
their paths (the plan forced to each), bf16 at atol 3e-2, rtol 1e-2.  Dropout cases run at rate 0.1 with one seed on both sides, which
then draw the same Philox mask.  The CTC alphas and d_em hold their finite
entries to atol 1e-4 and their -1e30 sentinels exactly.  The MMA alignment
recursion holds its alphas to atol 1e-4 and d_prefix and d_denom to 1e-4
of their largest entries (d_denom spans many orders of magnitude).  The
CIF integrate-and-fire holds out and delays to 1e-5 of their largest
entries (both sides take the same cumsums; only the order of the sums
over frames differs).  The grouped attention's example-id gate
(sequence-packed rows) holds its forward and backward to the dense
kernels' tolerances.  The FFN kernels' silu and tanh run fp32 and bf16
at these tolerances.  The bf16 LN-FFN forward's tiled path and its
backward run their products on the tensor cores: held to their plain
versions at the bf16 tolerance (with relu, the plain backward under the
kernel's own relu mask), the same bits twice, HGMMA in their SASS; so do
the bf16 FFN backward and linear-res backward (1 to 12,800 rows, D 256
and the padded D 200, gated and ungated, weight gradients within 1e-2
of their largest entry).  The CTC kernels run S 1025 and 2049 with
several states a thread.  The
widths above the old maxima (D 1280 / 2048, head dims 160 / 256, 96 /
128 channels a group) run their kernels at the fp32 tolerances.
"""
import pytest

torch = pytest.importorskip("torch")

from simulst_tpu_torch.ops import (cif_integrate, conv_pos, ctc,  # noqa: E402
                                   ffn, linear_res, mha, monotonic_align)
from simulst_tpu_torch.nn.emformer import (EmformerConfig,  # noqa: E402
                                           make_packed_eids)
from simulst_tpu_torch.ops.emformer_attn import (  # noqa: E402
    AttnGeom, EidGate, emformer_grouped_attention,
    emformer_grouped_attention_backward, emformer_grouped_attention_forward,
    grouped_attention_plain, grouped_attention_plain_backward)
from simulst_tpu_torch.ops.ffn import (  # noqa: E402
    TILED_MIN_ROWS, ffn_plain, ffn_plain_backward, fused_ffn,
    fused_ffn_backward, fused_ln_ffn_res, fused_ln_ffn_res_backward,
    ln_ffn_res_plain, ln_ffn_res_plain_backward)
from simulst_tpu_torch.ops.linear_res import (  # noqa: E402
    fused_linear_res, fused_linear_res_backward, linear_res_plain,
    linear_res_plain_backward)
from simulst_tpu_torch.ops.mha import (fused_mha_backward,  # noqa: E402
                                       fused_mha_forward, mha_plain,
                                       mha_plain_backward)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def randn():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    g = torch.Generator().manual_seed(0)
    return lambda *shape, scale=1.0: (torch.randn(shape, generator=g)
                                      * scale).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 33, 300, 4133, TILED_MIN_ROWS - 1,
                                  TILED_MIN_ROWS])
def test_ffn_kernels_match_plain(randn, rows):
    """Below TILED_MIN_ROWS the fused row-block kernel, from it on the
    tiled path (4,133: a short last 128-row tile)."""
    x = randn(rows, 256)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    before = (fused_ln_ffn_res.launches, fused_ffn.launches)
    torch.testing.assert_close(fused_ln_ffn_res(x, g, b, w1, b1, w2, b2),
                               ln_ffn_res_plain(x, g, b, w1, b1, w2, b2), **TOL)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2),
                               ffn_plain(x, w1, b1, w2, b2), **TOL)
    assert (fused_ln_ffn_res.launches, fused_ffn.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("period,res_rows", [(0, 0), (200, 192)])
def test_linear_res_kernel_matches_plain(randn, period, res_rows):
    h, res = randn(437, 256), randn(437, 256)
    w, b = randn(256, 256, scale=0.06), randn(256, scale=0.06)
    torch.testing.assert_close(
        fused_linear_res(h, w, b, res, period, res_rows),
        linear_res_plain(h, w, b, res, period, res_rows), **TOL)


# geometries (U, seg, lc, rc, max_mem, G) of the kernels' segment units:
# s2t_emformer_s's, rc > seg, lc not a multiple of seg, one memory slot,
# G 2 and 3; every batch holds a 5-frame utterance, whose later segments
# see no utterance key
GEOMS = {"U256-G8": (256, 16, 32, 8, 5, 8), "U128-G4": (128, 16, 32, 8, 5, 4),
         "rc12-seg8-G2": (48, 8, 16, 12, 5, 2),
         "lc20-G3": (96, 16, 20, 8, 5, 3), "mem1-G4": (128, 16, 32, 8, 1, 4)}
# fp32 as TOL; bf16 atol 3e-2, rtol 1e-2 (a flip of the last bf16 rounding)
DTYPES = {"fp32": (torch.float32, TOL),
          "bf16": (torch.bfloat16, dict(atol=3e-2, rtol=1e-2))}


def _dense(randn, geom_id, dtype):
    """(q3, k, v, lengths, dout, geom) of a 3-row batch of GEOMS[geom_id]."""
    U, seg, lc, rc, max_mem, G = GEOMS[geom_id]
    geom = AttnGeom(U=U, seg=seg, lc=lc, rc=rc, max_mem=max_mem, G=G,
                    num_heads=4)
    q3, dout = (randn(3, geom.ng, geom.nq, 256).to(dtype) for _ in range(2))
    k, v = (randn(3, geom.tk, 256).to(dtype) for _ in range(2))
    lengths = torch.tensor([U, U - 37, 5], dtype=torch.int32, device="cuda")
    return q3, k, v, lengths, dout, geom


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom_id", GEOMS)
def test_grouped_attention_kernel_matches_plain(randn, geom_id, dtype):
    dt, tol = DTYPES[dtype]
    q3, k, v, lengths, _, geom = _dense(randn, geom_id, dt)
    torch.testing.assert_close(
        emformer_grouped_attention(q3, k, v, lengths, geom),
        grouped_attention_plain(q3, k, v, lengths, geom), **tol)


def _close_to_largest(got, want, rtol=1e-4):
    """max |got - want| within rtol of the largest |want| entry."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", ["causal", "cross"])
def test_mha_kernels_match_plain(randn, case, rate):
    b, tq, tk = (3, 77, 77) if case == "causal" else (3, 77, 200)
    q, k, v, dout = (randn(b, t, 256) for t in (tq, tk, tk, tq))
    kmask = torch.ones(b, tk, dtype=torch.int32, device="cuda")
    kmask[1, 150 if tk > 77 else 60:] = 0
    if case == "cross":
        kmask[2] = 0                      # every query row sees no key
    args = (q, k, v, kmask, 4, case == "causal", rate, 1234)
    out, lse = fused_mha_forward(*args)
    torch.testing.assert_close(out, mha_plain(*args), **TOL)
    got = fused_mha_backward(q, k, v, kmask, out, lse, dout, *args[4:])
    want = mha_plain_backward(q, k, v, kmask, dout, *args[4:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    if case == "cross":
        assert not out[2].any()


@pytest.mark.cuda
def test_mha_kernels_take_bf16(randn):
    """bf16 in, fp32 softmax and sums; tolerance atol 3e-2, rtol 1e-2 (the
    kernel rounds the probabilities before the running sum is divided out,
    the plain version after: a 2^-8 relative flip)."""
    q, k, v, dout = (randn(2, 70, 256).to(torch.bfloat16) for _ in range(4))
    kmask = torch.ones(2, 70, dtype=torch.int32, device="cuda")
    kmask[0, 50:] = 0
    args = (q, k, v, kmask, 4, True, 0.1, 5)
    out, lse = fused_mha_forward(*args)
    torch.testing.assert_close(out, mha_plain(*args), atol=3e-2, rtol=1e-2)
    got = fused_mha_backward(q, k, v, kmask, out, lse, dout, *args[4:])
    want = mha_plain_backward(q, k, v, kmask, dout, *args[4:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=3e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,activation", [
    (1, "relu"), (1, "gelu"), (300, "relu"), (300, "gelu"), (4133, "gelu")])
def test_ffn_backward_matches_plain(randn, rows, activation, rate):
    """4,133 rows: three K slices of the weight products, the last one
    short, and a short last row tile; gelu there for the reason
    test_ln_ffn_backward_matches_plain gives."""
    x, dy = randn(rows, 256), randn(rows, 256)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    cfg = (activation, rate, rate, 77)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2, *cfg),
                               ffn_plain(x, w1, b1, w2, b2, *cfg), **TOL)
    got = fused_ffn_backward(x, w1, b1, w2, dy, *cfg)
    want = ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        _close_to_largest(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("period,res_rows", [(0, 0), (200, 192)])
def test_linear_res_backward_matches_plain(randn, period, res_rows, rate):
    h, res, dy = randn(437, 256), randn(437, 256), randn(437, 256)
    w, b = randn(256, 256, scale=0.06), randn(256, scale=0.06)
    cfg = (period, res_rows, rate, 99)
    torch.testing.assert_close(fused_linear_res(h, w, b, res, *cfg),
                               linear_res_plain(h, w, b, res, *cfg), **TOL)
    got = fused_linear_res_backward(h, w, dy, *cfg)
    want = linear_res_plain_backward(h, w, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w_ in zip(got[1:], want[1:]):
        _close_to_largest(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("rows,activation", [
    (1, "relu"), (1, "gelu"), (300, "relu"), (300, "gelu"),
    (4133, "gelu"), (12325, "gelu")])
def test_ln_ffn_backward_matches_plain(randn, rows, activation, rate):
    """1 and 300 rows: one K slice of the weight products; 4,133 and
    12,325: three slices (ops/ffn.py k_splits), the last one short, and
    row tiles cut short at the end.  The larger row counts run gelu: over
    thousands of rows some u lies within a rounding of 0, where relu's
    derivative flips between the kernel's sum and cuBLAS's, and moves that
    row of dx far beyond the tolerance (tools/kernel_bitcheck.py holds
    relu there to the previous kernels' bits)."""
    x, dy = randn(rows, 256), randn(rows, 256)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    cfg = (activation, rate, rate, 55)
    before = fused_ln_ffn_res_backward.launches
    torch.testing.assert_close(
        fused_ln_ffn_res(x, g, b, w1, b1, w2, b2, *cfg),
        ln_ffn_res_plain(x, g, b, w1, b1, w2, b2, *cfg), **TOL)
    got = fused_ln_ffn_res_backward(x, g, b, w1, b1, w2, dy, *cfg)
    want = ln_ffn_res_plain_backward(x, g, b, w1, b1, w2, dy, *cfg)
    assert fused_ln_ffn_res_backward.launches == before + 1
    torch.testing.assert_close(got[0], want[0], **TOL)
    for gw, w in zip(got[1:], want[1:]):
        _close_to_largest(gw, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom_id", GEOMS)
def test_grouped_attention_backward_matches_plain(randn, geom_id, dtype,
                                                  rate):
    dt, tol = DTYPES[dtype]
    q3, k, v, lengths, dout, geom = _dense(randn, geom_id, dt)
    args = (q3, k, v, lengths)
    counts = (emformer_grouped_attention.launches,
              emformer_grouped_attention_backward.launches)
    torch.testing.assert_close(
        emformer_grouped_attention(*args, geom, rate, 21),
        grouped_attention_plain(*args, geom, rate, 21), **tol)
    got = emformer_grouped_attention_backward(*args, dout, geom, rate, 21)
    want = grouped_attention_plain_backward(*args, dout, geom, rate, 21)
    for gw, w in zip(got, want):
        torch.testing.assert_close(gw, w, **tol)
    assert (emformer_grouped_attention.launches,
            emformer_grouped_attention_backward.launches) == \
        (counts[0] + 1, counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype_id", list(DTYPES))
@pytest.mark.parametrize("rows", [1, 40, 300, TILED_MIN_ROWS, 4133])
@pytest.mark.parametrize("activation", ["silu", "tanh"])
def test_ffn_kernels_take_silu_and_tanh(randn, activation, rows, dtype_id):
    """silu and tanh in both FFN kernels, forward and backward, at dropout
    0.1, on the fused (below TILED_MIN_ROWS) and the tiled path: fp32 at
    TOL and 1e-4 of the largest entry on weight gradients; bf16 at atol
    3e-2, rtol 1e-2 and 1e-2 of the largest entry."""
    dtype, tol = DTYPES[dtype_id]
    wtol = 1e-4 if dtype == torch.float32 else 1e-2
    x, dy = randn(rows, 256).to(dtype), randn(rows, 256).to(dtype)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    w1, b1, w2, b2 = (t.to(dtype) for t in (w1, b1, w2, b2))  # LN fp32
    cfg = (activation, 0.1, 0.1, 41)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2, *cfg),
                               ffn_plain(x, w1, b1, w2, b2, *cfg), **tol)
    torch.testing.assert_close(
        fused_ln_ffn_res(x, g, b, w1, b1, w2, b2, *cfg),
        ln_ffn_res_plain(x, g, b, w1, b1, w2, b2, *cfg), **tol)
    for got, want in (
            (fused_ffn_backward(x, w1, b1, w2, dy, *cfg),
             ffn_plain_backward(x, w1, b1, w2, dy, *cfg)),
            (fused_ln_ffn_res_backward(x, g, b, w1, b1, w2, dy, *cfg),
             ln_ffn_res_plain_backward(x, g, b, w1, b1, w2, dy, *cfg))):
        torch.testing.assert_close(got[0], want[0], **tol)
        for gw, w in zip(got[1:], want[1:]):
            _close_to_largest(gw, w, wtol)


@pytest.mark.cuda
def test_ln_ffn_and_grouped_attention_take_bf16(randn):
    """bf16 in, fp32 sums; tolerance atol 3e-2, rtol 1e-2 on outputs and
    activation gradients (a flip of the last bf16 rounding is 2^-8
    relative), 1e-2 of the largest entry on weight gradients.  The LN
    parameters are fp32 (bf16 ones raise)."""
    bf = torch.bfloat16
    ws = [(1 + randn(256, scale=0.1)), randn(256, scale=0.1),
          randn(256, 2048, scale=0.03), randn(2048, scale=0.02),
          randn(2048, 256, scale=0.03), randn(256, scale=0.02)]
    ws = ws[:2] + [w.to(bf) for w in ws[2:]]
    with pytest.raises(TypeError, match="float32"):
        fused_ln_ffn_res(randn(8, 256).to(bf), ws[0].to(bf), ws[1].to(bf),
                         *ws[2:])
    # 4,133 rows: three K slices of the weight products, with bf16 weights
    # that are 2-byte rows for the products' 8-byte loads
    for rows, act in ((300, "gelu"), (4133, "gelu")):
        x, dy = randn(rows, 256).to(bf), randn(rows, 256).to(bf)
        cfg = (act, 0.1, 0.1, 3)
        torch.testing.assert_close(fused_ln_ffn_res(x, *ws, *cfg),
                                   ln_ffn_res_plain(x, *ws, *cfg),
                                   atol=3e-2, rtol=1e-2)
        got = fused_ln_ffn_res_backward(x, *ws[:5], dy, *cfg)
        want = ln_ffn_res_plain_backward(x, *ws[:5], dy, *cfg)
        torch.testing.assert_close(got[0], want[0], atol=3e-2, rtol=1e-2)
        for gw, w in zip(got[1:], want[1:]):
            _close_to_largest(gw, w, 1e-2)
    geom = AttnGeom(U=128, seg=16, lc=32, rc=8, max_mem=5, G=4, num_heads=4)
    q3, dout = (randn(2, geom.ng, geom.nq, 256).to(bf) for _ in range(2))
    k, v = (randn(2, geom.tk, 256).to(bf) for _ in range(2))
    lengths = torch.tensor([128, 90], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(
        emformer_grouped_attention(q3, k, v, lengths, geom, 0.1, 8),
        grouped_attention_plain(q3, k, v, lengths, geom, 0.1, 8),
        atol=3e-2, rtol=1e-2)
    for gw, w in zip(
            emformer_grouped_attention_backward(q3, k, v, lengths, dout, geom,
                                                0.1, 8),
            grouped_attention_plain_backward(q3, k, v, lengths, dout, geom,
                                             0.1, 8)):
        torch.testing.assert_close(gw, w, atol=3e-2, rtol=1e-2)


# packed rows (train/packing.py): rows of n_p segments holding several
# examples, groups of G segments straddling example boundaries, a row that
# ends in dead segments and one dead row; s2t_emformer_s's geometry at G 7
# and 4, and the stressed unit geometries of GEOMS: (lengths, source U,
# n_p, rows, (seg, lc, rc, max_mem))
PACKED = {7: ([256, 240, 180, 100, 77, 30], 256, 28, 4, (16, 32, 8, 5)),
          4: ([128, 70, 50, 33, 20, 9], 128, 8, 4, (16, 32, 8, 5)),
          "rc12-seg8-G2": ([64, 40, 30, 17, 9, 5], 64, 10, 4, (8, 16, 12, 5)),
          "lc20-G3": ([128, 70, 50, 33, 20, 9], 128, 9, 4, (16, 20, 8, 5)),
          "mem1-G4": ([128, 70, 50, 33, 20, 9], 128, 8, 4, (16, 32, 8, 1))}


def _packed(randn, G, dtype=torch.float32):
    """(q3, k, v, full lengths, dout, geom, gate) of one packed batch."""
    from simulst_tpu_torch.train.packing import pack_plan
    lengths, u_src, n_p, n_rows, (seg, lc, rc, max_mem) = PACKED[G]
    group = G if isinstance(G, int) else GEOMS[G][-1]
    plan = pack_plan(lengths, u_src, seg, rc, n_rows=n_rows, row_segs=n_p)
    assert (plan.seg_eid == -1).all(axis=1).any()
    eids = make_packed_eids(
        EmformerConfig(right_context=rc, max_memory=max_mem),
        torch.from_numpy(plan.frame_eid), torch.from_numpy(plan.seg_eid))
    gate = EidGate(eids.kid.cuda(), eids.seg_eid.cuda())
    geom = AttnGeom(U=n_p * seg, seg=seg, lc=lc, rc=rc, max_mem=max_mem,
                    G=group, num_heads=4)
    q3, dout = (randn(n_rows, geom.ng, geom.nq, 256).to(dtype)
                for _ in range(2))
    k, v = (randn(n_rows, geom.tk, 256).to(dtype) for _ in range(2))
    full = torch.full((n_rows,), geom.U, dtype=torch.int32, device="cuda")
    return q3, k, v, full, dout, geom, gate


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", list(PACKED))
def test_gated_grouped_attention_matches_plain(randn, G, dtype, rate):
    """The gated kernels, forward and backward, vs the plain version with
    the gate; they count on gated_launches, not launches; and the gate
    changes the output."""
    dt, tol = DTYPES[dtype]
    q3, k, v, full, dout, geom, gate = _packed(randn, G, dt)
    args = (q3, k, v, full)
    counts = [(f.launches, f.gated_launches) for f in (
        emformer_grouped_attention, emformer_grouped_attention_backward)]
    out = emformer_grouped_attention(*args, geom, rate, 21, gate=gate)
    torch.testing.assert_close(
        out, grouped_attention_plain(*args, geom, rate, 21, gate), **tol)
    got = emformer_grouped_attention_backward(*args, dout, geom, rate, 21,
                                              gate)
    want = grouped_attention_plain_backward(*args, dout, geom, rate, 21,
                                            gate)
    for gw, w in zip(got, want):
        torch.testing.assert_close(gw, w, **tol)
    assert [(f.launches, f.gated_launches) for f in (
        emformer_grouped_attention,
        emformer_grouped_attention_backward)] == [(n, m + 1)
                                                  for n, m in counts]
    assert not torch.allclose(out, emformer_grouped_attention(
        *args, geom, rate, 21), atol=1e-3)


@pytest.mark.cuda
def test_gated_grouped_attention_takes_bf16(randn):
    """bf16 at G 4, rate 0.1: atol 3e-2, rtol 1e-2 (as the dense bf16
    case)."""
    q3, k, v, full, dout, geom, gate = _packed(randn, 4, torch.bfloat16)
    args = (q3, k, v, full)
    torch.testing.assert_close(
        emformer_grouped_attention(*args, geom, 0.1, 8, gate=gate),
        grouped_attention_plain(*args, geom, 0.1, 8, gate),
        atol=3e-2, rtol=1e-2)
    for gw, w in zip(
            emformer_grouped_attention_backward(*args, dout, geom, 0.1, 8,
                                                gate),
            grouped_attention_plain_backward(*args, dout, geom, 0.1, 8,
                                             gate)):
        torch.testing.assert_close(gw, w, atol=3e-2, rtol=1e-2)


@pytest.mark.cuda
def test_gated_grouped_attention_refuses_a_malformed_gate(randn):
    q3, k, v, full, dout, geom, gate = _packed(randn, 4)
    for bad in (EidGate(gate.kid.long(), gate.seg_eid),
                EidGate(gate.kid, gate.seg_eid[:, :-1]),
                EidGate(gate.kid.cpu(), gate.seg_eid)):
        with pytest.raises(ValueError, match="gate"):
            emformer_grouped_attention_forward(q3, k, v, full, geom,
                                               gate=bad)
        with pytest.raises(ValueError, match="gate"):
            emformer_grouped_attention_backward(q3, k, v, full, dout, geom,
                                                gate=bad)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,frames", [(3, 50), (32, 256), (33, 1),
                                          (13, 300)])
def test_convpos_wgrad_matches_plain(randn, batch, frames):
    """Batches of 3 and 13 (slices of 1 and 2: not a multiple of 8) and 33
    (7 slices of 5, the last of 3); 50, 1 and 300 frames, not a multiple of
    the kernel's 64-step tiles."""
    xp, dy = randn(batch, frames + 63, 256), randn(batch, frames, 256)
    before = conv_pos.convpos_wgrad.launches
    got = conv_pos.convpos_wgrad(xp, dy, 64, 16)
    assert conv_pos.convpos_wgrad.launches == before + 1
    assert got.shape == (256, 16, 64)
    _close_to_largest(got, conv_pos.convpos_wgrad_plain(xp, dy, 64, 16))


@pytest.mark.cuda
def test_convpos_wgrad_takes_bf16(randn):
    """bf16 xp and dy, widened exactly: the kernel's fp32 sums against the
    plain version's on the same bf16 values, 1e-4 of the largest entry."""
    xp = randn(5, 300 + 63, 256).to(torch.bfloat16)
    dy = randn(5, 300, 256).to(torch.bfloat16)
    got = conv_pos.convpos_wgrad(xp, dy, 64, 16)
    assert got.dtype == torch.float32 and got.shape == (256, 16, 64)
    _close_to_largest(got, conv_pos.convpos_wgrad_plain(xp, dy, 64, 16))


@pytest.mark.cuda
def test_ctc_kernels_match_plain(randn):
    """Alphas and d_em at T 60, B 4, S 2L+1 = 17, with an example whose
    target cannot fit its frames (zero_infinity) and frames past the
    input length."""
    t, b, L = 60, 4, 8
    em = torch.log_softmax(randn(t, b, 2 * L + 1), dim=-1)
    g = torch.Generator().manual_seed(1)
    targets = torch.randint(3, 9, (b, L), generator=g).cuda()
    targets[1, 3] = targets[1, 2]
    _, can_skip = ctc._ctc_masks(targets, 0)
    il = torch.tensor([60, 41, 5, 60], device="cuda")
    tl = torch.tensor([8, 5, 8, 0], device="cuda")   # example 2: impossible
    got = ctc.ctc_alphas(em, can_skip, il, tl)
    want = ctc.alphas_plain(em, can_skip, il, tl)
    sentinel = want <= ctc.NEG / 2
    assert torch.equal(got <= ctc.NEG / 2, sentinel)
    torch.testing.assert_close(got[~sentinel], want[~sentinel], **TOL)
    nll = ctc._nll_from_alpha(want[-1], tl)
    scale = torch.tensor([-1.0, -0.5, 0.0, -2.0], device="cuda")
    got = ctc.ctc_d_em(em, want, can_skip, il, tl, scale, nll)
    torch.testing.assert_close(got, ctc.d_em_plain(em, want, can_skip, il, tl,
                                                   scale, nll), **TOL)
    assert not got[5:, 2].any() and not got[41:, 1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("t,s", [(60, 33), (60, 257), (120, 1023),
                                 (120, 1025), (120, 2049), (1040, 2049)])
def test_ctc_alpha_paths_match_plain(randn, t, s):
    """Alphas at S 33 and 257 (2 and 11 warps refreshing halo states every
    4 steps), at S 1023 (32 warps exchanging border states every step) and
    at S 1025 and 2049 (2 and 4 states a thread): finite entries atol
    1e-4, the -1e30 sentinels equal.  The first two targets fit their
    frames, the third cannot, the fourth is empty."""
    b, L = 4, (s - 1) // 2
    em = torch.log_softmax(randn(t, b, s), dim=-1)
    g = torch.Generator().manual_seed(s + 1)
    targets = torch.randint(3, 9, (b, L), generator=g).cuda()
    targets[1, 3] = targets[1, 2]
    _, can_skip = ctc._ctc_masks(targets, 0)
    il = torch.tensor([t, t - 19, 5, t], device="cuda")
    tl = torch.tensor([min(L, t // 2), min(L // 2, t // 3), L, 0],
                      device="cuda")
    before = ctc.ctc_alphas.launches
    got = ctc.ctc_alphas(em, can_skip, il, tl)
    assert ctc.ctc_alphas.launches == before + 1
    want = ctc.alphas_plain(em, can_skip, il, tl)
    sentinel = want <= ctc.NEG / 2
    assert torch.equal(got <= ctc.NEG / 2, sentinel)
    assert torch.equal(got[sentinel], want[sentinel])
    torch.testing.assert_close(got[~sentinel], want[~sentinel], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,s", [(60, 33), (60, 65), (60, 129), (60, 257),
                                 (120, 1023), (1, 17), (120, 1025),
                                 (120, 2049), (1040, 2049)])
def test_ctc_d_em_paths_match_plain(randn, t, s):
    """d_em at S 33, 65, 129 and 257 (2 to 11 beta warps refreshing halo
    states every 4 steps), at S 1023 (32 warps exchanging border states
    every step), at T 1, S 17 (one beta warp) and at S 1025 and 2049 (2
    and 4 states a thread), each followed by the
    posterior kernel, on the kernel's alphas: finite entries atol 1e-4,
    zero past each input length.  The first two targets fit their frames
    (up to t / 2 and t / 3 labels), the third cannot, the fourth is
    empty."""
    b, L = 4, (s - 1) // 2
    em = torch.log_softmax(randn(t, b, s), dim=-1)
    g = torch.Generator().manual_seed(s)
    targets = torch.randint(3, 9, (b, L), generator=g).cuda()
    targets[1, 3] = targets[1, 2]
    _, can_skip = ctc._ctc_masks(targets, 0)
    il = torch.tensor([t, max(t - 19, 1), min(5, t), t], device="cuda")
    tl = torch.tensor([min(L, t // 2), min(L // 2, t // 3), L, 0],
                      device="cuda")
    alphas = ctc.ctc_alphas(em, can_skip, il, tl)
    nll = ctc._nll_from_alpha(alphas[-1], tl)
    scale = torch.tensor([-1.0, -0.5, 0.0, -2.0], device="cuda")
    before = ctc.ctc_d_em.launches
    got = ctc.ctc_d_em(em, alphas, can_skip, il, tl, scale, nll)
    assert ctc.ctc_d_em.launches == before + 1
    torch.testing.assert_close(got, ctc.d_em_plain(em, alphas, can_skip, il,
                                                   tl, scale, nll), **TOL)
    for k in range(b):
        assert not got[int(il[k]):, k].any()


@pytest.mark.cuda
def test_ctc_kernels_raise_above_their_states(randn):
    """Above ops/ctc.MAX_STATES the wrappers raise (no quiet fall back
    to the plain DP); at it they launch."""
    for s, raises in ((ctc.MAX_STATES + 2, True), (ctc.MAX_STATES, False)):
        em = torch.log_softmax(randn(3, 1, s), dim=-1)
        skip = torch.zeros(1, s, dtype=torch.int32, device="cuda")
        lengths = torch.tensor([3], device="cuda")
        tl = torch.tensor([1], device="cuda")
        if raises:
            with pytest.raises(ValueError, match="S <="):
                ctc.ctc_alphas(em, skip, lengths, tl)
            with pytest.raises(ValueError, match="S <="):
                ctc.ctc_d_em(em, em, skip, lengths, tl, tl.float(),
                             tl.float())
            continue
        got = ctc.ctc_alphas(em, skip, lengths, tl)
        want = ctc.alphas_plain(em, skip, lengths, tl)
        sentinel = want <= ctc.NEG / 2
        assert torch.equal(got[sentinel], want[sentinel])
        torch.testing.assert_close(got[~sentinel], want[~sentinel], **TOL)


@pytest.mark.cuda
def test_ctc_d_em_log1p_is_log1pf_at_every_input(randn):
    """The d_em kernel's branch-free log1p equals the math library's log1pf
    in every bit at all 2^32 fp32 inputs."""
    assert ctc.d_em_log1p_mismatches(randn(1).device) == 0


def _alignment_panels(n, u, s, waitk=False):
    """prefix, denom as expected_alignment_from_p_choose makes them from a
    seeded p in [0.05, 0.95] (or wait-k's one-hot rows, lagging 3), and an
    upstream gradient, on the card."""
    g = torch.Generator().manual_seed(n * u + s)
    if waitk:
        steps = torch.clamp(torch.arange(u) + 2, max=s - 1)
        p = (torch.arange(s)[None, :] == steps[:, None]).float().expand(
            n, u, s)
    else:
        p = 0.05 + 0.9 * torch.rand(n, u, s, generator=g)
    cp = torch.exp(torch.cumsum(torch.log(torch.cat(
        [torch.ones(n, u, 1), 1 - p], dim=2) + 1e-6), dim=2))[..., :s]
    return [t.contiguous().cuda() for t in (
        p * cp, torch.clamp(cp, 1e-6, 1.0), torch.randn(n, u, s, generator=g))]


@pytest.mark.cuda
@pytest.mark.parametrize("n,u,s,waitk", [
    (128, 72, 32, False), (128, 72, 256, False), (128, 1, 29, False),
    (7, 5, 700, False), (128, 72, 32, True), (128, 72, 1, False),
    (128, 72, 33, False), (128, 72, 200, False), (128, 72, 257, False),
    (128, 2, 32, False)],
    ids=["pooled", "unpooled", "ragged-U1", "S>block", "waitk", "S1", "S33",
         "S200", "S257", "U2"])
def test_alignment_kernels_match_plain(randn, n, u, s, waitk):
    """The recipe's pooled shape (N 128, U 72, S 32), the unpooled one (S
    256), a ragged one (S 29, U 1), S above 256 (three tiles), wait-k's
    one-hot rows, and the edges of the layout: S 1, S 33 (two groups of
    32, one lane of the second), S 200 (7 groups), S 257 (two tiles, one
    position in the second) and U 2."""
    prefix, denom, g = _alignment_panels(n, u, s, waitk)
    before = (monotonic_align.alignment_fwd.launches,
              monotonic_align.alignment_bwd.launches)
    alphas = monotonic_align.alignment_fwd(prefix, denom)
    torch.testing.assert_close(
        alphas, monotonic_align.alignment_fwd_plain(prefix, denom),
        atol=1e-4, rtol=0)
    got = monotonic_align.alignment_bwd(prefix, denom, alphas, g)
    want = monotonic_align.alignment_bwd_plain(prefix, denom, alphas, g)
    for gw, w in zip(got, want):
        _close_to_largest(gw, w)
    assert (monotonic_align.alignment_fwd.launches,
            monotonic_align.alignment_bwd.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_alignment_kernels_divide_as_the_plain_versions_at_s1(randn):
    """At S 1 no cumsum adds anything, so the kernels and the plain
    versions run the same fp32 operations in the same order: their outputs
    are equal, bit for bit, when the kernels' quotients are correctly
    rounded as torch's division rounds them.  Operands over wide magnitudes
    (prefix 2^-149 .. 1 and zeros, denom +-2^-20 .. 2^40, g +-2^-149 ..
    2^10 and zeros) give zero, subnormal and tiny quotients and
    dividends, which take the slow path of CUDA's own fp32 division."""
    g = torch.Generator().manual_seed(12)
    n, u = 1 << 18, 4

    def magnitudes(lo, hi, signed, zeros):
        e = torch.randint(lo, hi + 1, (n, u, 1), generator=g)
        x = torch.ldexp(1 + torch.rand(n, u, 1, generator=g), e)
        if signed:
            x = torch.where(torch.rand(n, u, 1, generator=g) < 0.5, -x, x)
        x[torch.rand(n, u, 1, generator=g) < zeros] = 0.0
        return x.float().cuda()

    prefix = magnitudes(-150, -1, False, 0.1)
    denom = magnitudes(-21, 39, True, 0.0)
    grad = magnitudes(-150, 9, True, 0.1)
    alphas = monotonic_align.alignment_fwd(prefix, denom)
    assert torch.equal(alphas,
                       monotonic_align.alignment_fwd_plain(prefix, denom))
    assert (alphas != 0).any() and (alphas < 2.0 ** -126).any()
    got = monotonic_align.alignment_bwd(prefix, denom, alphas, grad)
    want = monotonic_align.alignment_bwd_plain(prefix, denom, alphas, grad)
    for gw, w in zip(got, want):
        assert torch.isfinite(w).all() and torch.equal(gw, w)


@pytest.mark.cuda
def test_alignment_kernels_refuse_what_they_do_not_take(randn):
    prefix, denom, g = _alignment_panels(2, 3, 8)
    with pytest.raises(TypeError):
        monotonic_align.alignment_fwd(prefix.double(), denom.double())
    with pytest.raises(ValueError):
        monotonic_align.alignment_fwd(prefix, denom[:, :2])
    with pytest.raises(ValueError):
        monotonic_align.alignment_bwd(prefix, denom, prefix, g[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c,t,beta,how", [
    (32, 256, 256, 65, 1.0, ""),      # the cif-train batch
    (1, 17, 256, 19, 1.0, ""),        # a streaming chunk: carry + 16 frames
    (4, 29, 256, 1, 1.0, ""),         # ragged, one bucket
    (2, 512, 256, 300, 1.0, ""),      # more than 128 buckets, one scan pass
    (8, 256, 256, 80, 0.8, ""),       # test-time beta
    (3, 40, 300, 12, 1.0, ""),        # C above one block's 256 channels
    (4, 64, 256, 40, 1.0, "wide"),    # frames spanning three buckets
    (2, 12, 256, 40, 1.0, "wide"),    # T > S: every frame that wide
    (4, 128, 256, 48, 1.0, "zeros"),  # zero-weight runs and a zero row
    (2, 1100, 256, 300, 1.0, ""),     # three scan passes of 512 frames
    (3, 40, 130, 12, 1.0, "")])       # C not a multiple of 4: 4-byte copies
def test_cif_integrate_matches_plain(randn, b, s, c, t, beta, how):
    x = randn(b, s, c)
    alpha = torch.sigmoid(randn(b, s))
    alpha[0, s // 2:] = 0.0                          # padding
    if how == "wide":
        alpha[:, 3::3] = 2.0 + alpha[:, 3::3]
        if s < t:
            alpha = 2.5 + alpha
    elif how == "zeros":
        alpha[:, 10:30] = 0.0
        alpha[-1] = 0.0
    before = cif_integrate.cif_integrate.launches
    out, delays = cif_integrate.cif_integrate(x, alpha, beta, t)
    assert cif_integrate.cif_integrate.launches == before + 1
    want = cif_integrate.cif_integrate_plain(x, alpha, beta, t)
    for got, ref in zip((out, delays), want):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err
    xg, ag = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    out, delays = cif_integrate.cif_integrate(xg, ag, beta, t)
    ((out ** 2).sum() + delays.sum()).backward()
    xp, ap = x.clone().requires_grad_(), alpha.clone().requires_grad_()
    out, delays = cif_integrate.cif_integrate_plain(xp, ap, beta, t)
    ((out ** 2).sum() + delays.sum()).backward()
    for got, ref in ((xg.grad, xp.grad), (ag.grad, ap.grad)):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_cif_integrate_c_entry_takes_a_csum_that_dips(randn):
    """An fp32 cumsum on the card need not be monotone to the last ulp:
    the C entry, given a csum that falls by one ulp at a few frames, agrees
    with the plain portion product on that csum."""
    from simulst_tpu_torch.ops import _build
    b, s, c, t, beta = 2, 64, 256, 24, 1.0
    x = randn(b, s, c)
    alpha = torch.sigmoid(randn(b, s))
    csum = torch.cumsum(alpha, dim=1)
    for row, k in ((0, 5), (1, 20), (1, 41)):
        csum[row, k] = torch.nextafter(csum[row, k - 1],
                                       torch.tensor(-1.0, device="cuda"))
    assert (csum[:, 1:] < csum[:, :-1]).any()
    out = torch.empty(b, t, c, device="cuda")
    delays = torch.empty(b, t, device="cuda")
    _build.launch("simulst_cif_integrate", x.data_ptr(), csum.data_ptr(),
                  alpha.data_ptr(), out.data_ptr(), delays.data_ptr(), b, s,
                  t, c, beta, _build.stream_of(x))
    portion = cif_integrate.portions(csum, csum - alpha, beta, t)
    want = (torch.einsum("bst,bsc->btc", portion, x),
            torch.einsum("bst,s->bt", portion, torch.arange(
                1, s + 1, dtype=torch.float32, device="cuda")) / beta)
    for got, ref in zip((out, delays), want):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.cuda
def test_ln_ffn_backward_takes_misaligned_weights(randn):
    """Weights whose data does not start on a 16-byte boundary (a view
    at an odd offset) are copied to one for the products' 16-byte loads."""
    x, dy = randn(300, 256), randn(300, 256)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1 = randn(256 * 2048 + 1, scale=0.03)[1:].view(256, 2048)
    b1 = randn(2048, scale=0.02)
    w2 = randn(2048 * 256 + 1, scale=0.03)[1:].view(2048, 256)
    assert w1.data_ptr() % 16 and w2.data_ptr() % 16
    cfg = ("gelu", 0.1, 0.1, 5)
    got = fused_ln_ffn_res_backward(x, g, b, w1, b1, w2, dy, *cfg)
    want = ln_ffn_res_plain_backward(x, g, b, w1, b1, w2, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for gw, w in zip(got[1:], want[1:]):
        _close_to_largest(gw, w)


def _misaligned(randn, *shape, scale=1.0):
    """A view whose data does not start on a 16-byte boundary."""
    n = 1
    for k in shape:
        n *= k
    t = randn(n + 1, scale=scale)[1:].view(*shape)
    assert t.data_ptr() % 16
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("ln_res", [True, False])
def test_ffn_takes_misaligned_operands(randn, ln_res):
    """The tiled forward's operands x, W1 and W2, given as views at an odd
    offset, are copied to a 16-byte boundary for the products' loads."""
    rows = max(300, TILED_MIN_ROWS)
    x = _misaligned(randn, rows, 256)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1, b1 = _misaligned(randn, 256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = _misaligned(randn, 2048, 256, scale=0.03), randn(256, scale=0.02)
    cfg = ("gelu", 0.1, 0.1, 5)
    if ln_res:
        got = fused_ln_ffn_res(x, g, b, w1, b1, w2, b2, *cfg)
        want = ln_ffn_res_plain(x, g, b, w1, b1, w2, b2, *cfg)
    else:
        got = fused_ffn(x, w1, b1, w2, b2, *cfg)
        want = ffn_plain(x, w1, b1, w2, b2, *cfg)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.cuda
def test_ffn_backward_takes_misaligned_operands(randn):
    x, dy = _misaligned(randn, 300, 256), randn(300, 256)
    w1, b1 = _misaligned(randn, 256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2 = _misaligned(randn, 2048, 256, scale=0.03)
    cfg = ("gelu", 0.1, 0.1, 5)
    got = fused_ffn_backward(x, w1, b1, w2, dy, *cfg)
    want = ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for gw, w in zip(got[1:], want[1:]):
        _close_to_largest(gw, w)


@pytest.mark.cuda
def test_linear_res_backward_takes_a_misaligned_ragged_view(randn):
    """301 rows (not a multiple of 4) with the Emformer gate; h and w as
    views at an odd offset, copied to a 16-byte boundary for the
    products' loads."""
    h, dy = _misaligned(randn, 301, 256), randn(301, 256)
    w = _misaligned(randn, 256, 256, scale=0.06)
    cfg = (25, 24, 0.1, 3)
    got = fused_linear_res_backward(h, w, dy, *cfg)
    want = linear_res_plain_backward(h, w, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w_ in zip(got[1:], want[1:]):
        _close_to_largest(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_backward_takes_ragged_causal_shapes(randn, dtype):
    """Tq 50 != Tk 77 (neither a multiple of the 64-row tiles), causal,
    ragged key masks and one example whose keys are all masked; fp32 as
    views at an odd offset (copied to a 16-byte boundary), bf16 at the
    bf16 tolerance of test_mha_kernels_take_bf16."""
    q, dout = (_misaligned(randn, 3, 50, 256) for _ in range(2))
    k, v = (_misaligned(randn, 3, 77, 256) for _ in range(2))
    if dtype == torch.bfloat16:
        q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    kmask = torch.ones(3, 77, dtype=torch.int32, device="cuda")
    kmask[0, 40:] = 0
    kmask[1] = 0
    args = (q, k, v, kmask, 4, True, 0.1, 8)
    out, lse = fused_mha_forward(*args)
    got = fused_mha_backward(q, k, v, kmask, out, lse, dout, *args[4:])
    want = mha_plain_backward(q, k, v, kmask, dout, *args[4:])
    tol = TOL if dtype == torch.float32 else dict(atol=3e-2, rtol=1e-2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol)
    assert not got[0][1].any()       # rows that see no key: dq is zero


@pytest.mark.cuda
def test_cif_integrate_refuses_what_it_does_not_take(randn):
    x, alpha = randn(2, 8, 16), torch.sigmoid(randn(2, 8))
    with pytest.raises(ValueError):
        cif_integrate.cif_integrate(x, alpha[:, :5], 1.0, 4)
    with pytest.raises(ValueError):
        cif_integrate.cif_integrate(x, alpha, 0.0, 4)
    with pytest.raises(ValueError):
        cif_integrate.cif_integrate(x, alpha.cpu(), 1.0, 4)
    with pytest.raises(TypeError):   # fp32 only; the caller casts
        cif_integrate.cif_integrate(x.bfloat16(), alpha, 1.0, 4)


# the linear-res forward's shapes: (rows, period, residual rows)
LR_FWD_SHAPES = {"step-1": (1, 0, 0), "step-40": (40, 0, 0),
                 "asr-decoder-2304": (2304, 0, 0),
                 "offline-encoder-3200-gate": (3200, 200, 192),
                 "mt-8192": (8192, 0, 0),
                 "asr-encoder-12800-gate": (12800, 200, 192)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", list(linear_res.FWD_PATHS))
@pytest.mark.parametrize("shape", LR_FWD_SHAPES)
def test_linear_res_forward_paths_match_plain(randn, monkeypatch, shape,
                                              path, dtype):
    """Each path at each shape the main paths run (rate 0.1); one launch
    per call whichever path runs."""
    dt, tol = DTYPES[dtype]
    rows, period, res_rows = LR_FWD_SHAPES[shape]
    h, res = randn(rows, 256).to(dt), randn(rows, 256).to(dt)
    w, b = randn(256, 256, scale=0.06).to(dt), randn(256, scale=0.06).to(dt)
    monkeypatch.setattr(linear_res, "fwd_plan", lambda n: path)
    cfg = (period, res_rows, 0.1, 21)
    before = fused_linear_res.launches
    torch.testing.assert_close(fused_linear_res(h, w, b, res, *cfg),
                               linear_res_plain(h, w, b, res, *cfg), **tol)
    assert fused_linear_res.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(linear_res.FWD_PATHS))
def test_linear_res_forward_takes_a_misaligned_view(randn, monkeypatch,
                                                    path):
    """h and w as views at an odd offset, copied to a 16-byte boundary for
    the kernels' loads; 301 rows with the Emformer gate."""
    h, res = _misaligned(randn, 301, 256), randn(301, 256)
    w, b = _misaligned(randn, 256, 256, scale=0.06), randn(256, scale=0.06)
    monkeypatch.setattr(linear_res, "fwd_plan", lambda n: path)
    cfg = (25, 24, 0.1, 3)
    torch.testing.assert_close(fused_linear_res(h, w, b, res, *cfg),
                               linear_res_plain(h, w, b, res, *cfg), **TOL)


# the MHA forward's shapes: (B, Tq, Tk, causal, key mask: "full", "ragged"
# or "masked row", ragged with example 1 seeing no key)
MHA_FWD_SHAPES = {
    "mt-self-causal": (64, 128, 128, True, "ragged"),
    "mt-encoder-self": (64, 128, 128, False, "full"),
    "mt-cross": (64, 128, 128, False, "masked row"),
    "asr-self-causal": (32, 72, 72, True, "ragged"),
    "asr-cross": (32, 72, 256, False, "ragged"),
    "step-cross": (40, 1, 256, False, "masked row"),
    "step-self-cache": (40, 1, 64, False, "ragged"),
    "decode-rows-causal": (5, 6, 77, True, "masked row")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", list(mha.FWD_PATHS))
@pytest.mark.parametrize("shape", MHA_FWD_SHAPES)
def test_mha_forward_paths_match_plain(randn, monkeypatch, shape, path,
                                       dtype):
    """Each kernel at each shape the main paths run (rate 0.1); rows that
    see no key give exact zeros; one launch per call."""
    dt, tol = DTYPES[dtype]
    b, tq, tk, causal, mask = MHA_FWD_SHAPES[shape]
    q = randn(b, tq, 256).to(dt)
    k, v = randn(b, tk, 256).to(dt), randn(b, tk, 256).to(dt)
    lengths = torch.arange(b, device="cuda") * 7 % (tk - tk // 2 + 1) \
        + tk // 2
    kmask = (torch.arange(tk, device="cuda")[None, :] < lengths[:, None]
             if mask != "full" else torch.ones(b, tk, device="cuda") > 0)
    kmask = kmask.to(torch.int32)
    if mask == "masked row":
        kmask[1] = 0
    monkeypatch.setattr(mha, "fwd_plan", lambda n: path)
    args = (q, k, v, kmask, 4, causal, 0.1, 17)
    before = mha.fused_mha.launches
    out, lse = fused_mha_forward(*args)
    assert mha.fused_mha.launches == before + 1
    torch.testing.assert_close(out, mha_plain(*args), **tol)
    assert lse.shape == (b, 4, tq) and not torch.isnan(lse).any()
    if mask == "masked row":
        assert not out[1].any() and torch.isinf(lse[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(mha.FWD_PATHS))
def test_mha_forward_takes_misaligned_views(randn, monkeypatch, path):
    """q, k and v as views at an odd offset (copied to a 16-byte
    boundary), the decoder step's Tq = 1 and a causal Tq = 50."""
    for tq, causal in ((1, False), (50, True)):
        q = _misaligned(randn, 3, tq, 256)
        k, v = (_misaligned(randn, 3, 77, 256) for _ in range(2))
        kmask = torch.ones(3, 77, dtype=torch.int32, device="cuda")
        kmask[0, 40:] = 0
        monkeypatch.setattr(mha, "fwd_plan", lambda n: path)
        args = (q, k, v, kmask, 4, causal, 0.1, 8)
        torch.testing.assert_close(fused_mha_forward(*args)[0],
                                   mha_plain(*args), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 64])
def test_ffn_kernels_at_the_batched_stream_rows(randn, batch):
    """The batched streaming evaluator's shapes: the Emformer block's
    LN-FFN on (B, rc 8 + segment 16, 256), 192 rows (the fused kernel) at
    B 8 and 1,536 (the tiled path) at B 64, and the decoder step's FFN on
    (B, 1, 256)."""
    x = randn(batch, 24, 256)
    g, b = 1 + randn(256, scale=0.1), randn(256, scale=0.1)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    assert (batch * 24 >= TILED_MIN_ROWS) == (batch == 64)
    before = (fused_ln_ffn_res.launches, fused_ffn.launches)
    torch.testing.assert_close(fused_ln_ffn_res(x, g, b, w1, b1, w2, b2),
                               ln_ffn_res_plain(x, g, b, w1, b1, w2, b2), **TOL)
    step = randn(batch, 1, 256)
    torch.testing.assert_close(fused_ffn(step, w1, b1, w2, b2),
                               ffn_plain(step, w1, b1, w2, b2), **TOL)
    assert (fused_ln_ffn_res.launches, fused_ffn.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("s,valid", [
    (17, None),                        # a steady chunk: carry + 16 frames
    (25, "ragged")])                   # the flush: carry + up to 24 frames
def test_cif_integrate_at_the_batched_stream_shapes(randn, s, valid):
    """cif_integrate at B 64 as the batched CIF step calls it (T = S + 2):
    a steady chunk, and the final flush whose frames past each example's
    x_valid (0 to 24, the carried tail always valid) weigh zero."""
    b, c, t, beta = 64, 256, s + 2, 1.0
    x = randn(b, s, c)
    alpha = torch.sigmoid(randn(b, s))
    if valid:
        x_valid = torch.arange(b, device="cuda") % s
        alpha = torch.where(torch.arange(s, device="cuda")[None, :]
                            <= x_valid[:, None], alpha,
                            torch.zeros_like(alpha))
    before = cif_integrate.cif_integrate.launches
    out, delays = cif_integrate.cif_integrate(x, alpha, beta, t)
    assert cif_integrate.cif_integrate.launches == before + 1
    want = cif_integrate.cif_integrate_plain(x, alpha, beta, t)
    for got, ref in zip((out, delays), want):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_label_encoder_kernels_at_the_transducer_shapes(randn, rate):
    """The transducer's label encoder at exp/6's train batch: its causal
    self-attention on (16, 73, 256), 4 heads, label lengths 40 to 73, and
    its FFN on the 1,168 rows, forward and backward; then the decode
    step's FFN on B x beam = 40 rows and B = 8."""
    b, t = 16, 73
    q, k, v, dout = (randn(b, t, 256) for _ in range(4))
    lengths = torch.linspace(40, t, b, device="cuda").long()
    kmask = (torch.arange(t, device="cuda")[None, :]
             < lengths[:, None]).to(torch.int32)
    args = (q, k, v, kmask, 4, True, rate, 4321)
    out, lse = fused_mha_forward(*args)
    torch.testing.assert_close(out, mha_plain(*args), **TOL)
    got = fused_mha_backward(q, k, v, kmask, out, lse, dout, *args[4:])
    want = mha_plain_backward(q, k, v, kmask, dout, *args[4:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    x, dy = randn(b * t, 256), randn(b * t, 256)
    w1, b1 = randn(256, 2048, scale=0.03), randn(2048, scale=0.02)
    w2, b2 = randn(2048, 256, scale=0.03), randn(256, scale=0.02)
    cfg = ("gelu", rate, rate, 99)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2, *cfg),
                               ffn_plain(x, w1, b1, w2, b2, *cfg), **TOL)
    got = fused_ffn_backward(x, w1, b1, w2, dy, *cfg)
    want = ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1:], want[1:]):
        _close_to_largest(g, w)
    for rows in (40, 8):
        step = randn(rows, 1, 256)
        torch.testing.assert_close(fused_ffn(step, w1, b1, w2, b2),
                                   ffn_plain(step, w1, b1, w2, b2), **TOL)


# the corners of the widths the kernels take: (D, heads, hidden), head
# dims 16, 32, 96 and 128, D 64 to 1024, hidden up to 4096; then widths
# that reach the kernels zero-padded: D 16, 48 and 200, hidden 32, 48, 100
# and 800, head dims 4, 8, 12, 50 and 100
WIDTH_CORNERS = [(64, 4, 256), (128, 4, 512), (384, 4, 1536),
                 (512, 4, 2048), (1024, 8, 4096), (16, 4, 32), (16, 2, 48),
                 (48, 4, 100), (200, 4, 800), (200, 2, 48),
                 # above the old maxima: D 1280 and 2048 (the LN row passes
                 # walking each row), head dims 160 and 256 (the wide
                 # attention kernels)
                 (1280, 8, 2560), (2048, 8, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,hidden", WIDTH_CORNERS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_kernels_take_every_width(randn, d, heads, hidden, rate):
    """At each corner: the FFN and LN-FFN forward and backward at 300 and
    40 rows (the fused and the tiled forward where D has a fused kernel),
    fused_mha at (8, 40, 40) causal and a decoder step's Tq 1 over 77 keys,
    the grouped attention at a two-group geometry (rc 4, seg 8, lc 16, 3
    memory slots) with a ragged length, each against its plain version at
    TOL, weight gradients within 1e-4 of their largest entry; every one
    of the eight wrappers launches its kernel."""
    counted = (fused_ln_ffn_res, fused_ln_ffn_res_backward, fused_ffn,
               fused_ffn_backward, mha.fused_mha, fused_mha_backward,
               emformer_grouped_attention,
               emformer_grouped_attention_backward)
    before = [f.launches for f in counted]
    xav = (6.0 / (d + hidden)) ** 0.5
    ln_g, ln_b = 1 + randn(d, scale=0.1), randn(d, scale=0.1)
    w1, b1 = randn(d, hidden, scale=xav), randn(hidden, scale=0.02)
    w2, b2 = randn(hidden, d, scale=xav), randn(d, scale=0.02)
    cfg = ("gelu", rate, rate, 31)
    for rows in (300, 40):
        x, dy = randn(rows, d), randn(rows, d)
        torch.testing.assert_close(
            fused_ln_ffn_res(x, ln_g, ln_b, w1, b1, w2, b2, *cfg),
            ln_ffn_res_plain(x, ln_g, ln_b, w1, b1, w2, b2, *cfg), **TOL)
        torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2, *cfg),
                                   ffn_plain(x, w1, b1, w2, b2, *cfg), **TOL)
        got = fused_ln_ffn_res_backward(x, ln_g, ln_b, w1, b1, w2, dy, *cfg)
        want = ln_ffn_res_plain_backward(x, ln_g, ln_b, w1, b1, w2, dy, *cfg)
        torch.testing.assert_close(got[0], want[0], **TOL)
        for g, w in zip(got[1:], want[1:]):
            _close_to_largest(g, w)
        got = fused_ffn_backward(x, w1, b1, w2, dy, *cfg)
        want = ffn_plain_backward(x, w1, b1, w2, dy, *cfg)
        torch.testing.assert_close(got[0], want[0], **TOL)
        for g, w in zip(got[1:], want[1:]):
            _close_to_largest(g, w)
    for b, tq, tk, causal in ((8, 40, 40, True), (8, 1, 77, False)):
        q, dout = randn(b, tq, d), randn(b, tq, d)
        k, v = randn(b, tk, d), randn(b, tk, d)
        lengths = torch.linspace(tk // 2, tk, b, device="cuda").long()
        kmask = (torch.arange(tk, device="cuda")[None, :]
                 < lengths[:, None]).to(torch.int32)
        args = (q, k, v, kmask, heads, causal, rate, 4321)
        out, lse = fused_mha_forward(*args)
        torch.testing.assert_close(out, mha_plain(*args), **TOL)
        got = fused_mha_backward(q, k, v, kmask, out, lse, dout, *args[4:])
        want = mha_plain_backward(q, k, v, kmask, dout, *args[4:])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
    geom = AttnGeom(U=32, seg=8, lc=16, rc=4, max_mem=3, G=2,
                    num_heads=heads)
    q3, dout = (randn(2, geom.ng, geom.nq, d) for _ in range(2))
    k, v = randn(2, geom.tk, d), randn(2, geom.tk, d)
    lengths = torch.tensor([32, 21], dtype=torch.int32, device="cuda")
    args = (q3, k, v, lengths, geom, rate, 77)
    torch.testing.assert_close(emformer_grouped_attention_forward(*args),
                               grouped_attention_plain(*args), **TOL)
    got = emformer_grouped_attention_backward(q3, k, v, lengths, dout,
                                              *args[4:])
    want = grouped_attention_plain_backward(q3, k, v, lengths, dout,
                                            *args[4:])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    assert all(f.launches > n for f, n in zip(counted, before))


@pytest.mark.cuda
@pytest.mark.parametrize("d,groups", [(64, 16), (512, 16), (1024, 16),
                                      (256, 256), (32, 16), (48, 16),
                                      (96, 16), (800, 16), (1536, 16),
                                      (2048, 16), (200, 2)])
def test_convpos_wgrad_takes_every_channel_count(randn, d, groups):
    """4, 32, 64 and 1 channels a group, 2, 3, 6 and 50 (padded to 4, 4, 8
    and 52), and above the old maximum of 64: 96, 128 and 100 (padded to
    104), K 64, (B, T) (5, 70): within 1e-4 of the largest entry, through
    the kernel (its launch counted)."""
    xp, dy = randn(5, 70 + 63, d), randn(5, 70, d)
    before = conv_pos.convpos_wgrad.launches
    _close_to_largest(conv_pos.convpos_wgrad(xp, dy, 64, groups),
                      conv_pos.convpos_wgrad_plain(xp, dy, 64, groups))
    assert conv_pos.convpos_wgrad.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("din,dout", [(16, 16), (48, 200), (200, 48),
                                      (200, 200), (256, 256), (1280, 1280),
                                      (1280, 200), (2000, 1280)])
@pytest.mark.parametrize("rows", [40, 300, 2304])
def test_linear_res_takes_every_width(randn, din, dout, rows):
    """D_in and D_out of 16, 48 and 200 (padded to multiples of 32 and
    64), 256, and above the old maximum of 1024: 1280 and 2000, rate 0.1
    with the Emformer gate, on the row kernel (40, 300 rows) and the tiled
    path (2,304): the forward and backward against
    the plain versions at TOL, weight gradients within 1e-4 of their
    largest entry, each call a launch."""
    h, res, dy = randn(rows, din), randn(rows, dout), randn(rows, dout)
    w, b = randn(din, dout, scale=din ** -0.5), randn(dout, scale=0.02)
    cfg = (20, 12, 0.1, 7)
    before = (fused_linear_res.launches, fused_linear_res_backward.launches)
    torch.testing.assert_close(
        linear_res.fused_linear_res_forward(h, w, b, res, *cfg),
        linear_res_plain(h, w, b, res, *cfg), **TOL)
    got = fused_linear_res_backward(h, w, dy, *cfg)
    want = linear_res_plain_backward(h, w, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w_ in zip(got[1:], want[1:]):
        _close_to_largest(g, w_)
    assert (fused_linear_res.launches, fused_linear_res_backward.launches) \
        == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_wrappers_raise_outside_the_widths(randn):
    """A CUDA tensor of a width no kernel takes (D not a whole number of
    heads or groups, no width at all) gives a ValueError naming it, never
    the plain version; D 1088, head dim 136 and 68 channels a group, above
    the old maxima, run their kernels (their launches counted)."""
    with pytest.raises(ValueError, match="D=0"):
        fused_ffn(randn(4, 0), randn(0, 128), randn(128), randn(128, 0),
                  randn(0))
    q = randn(2, 3, 4 * 136)
    kmask = torch.ones(2, 3, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        fused_mha_forward(q, q, q, kmask, 3)
    with pytest.raises(ValueError, match="channel"):
        conv_pos.convpos_wgrad(randn(2, 20, 1088), randn(2, 5, 1088), 16, 3)
    x = randn(4, 1088)
    before = (fused_ffn.launches, fused_linear_res.launches,
              mha.fused_mha.launches, conv_pos.convpos_wgrad.launches)
    xav = (6.0 / (1088 + 128)) ** 0.5
    w1, b1 = randn(1088, 128, scale=xav), randn(128, scale=0.02)
    w2, b2 = randn(128, 1088, scale=xav), randn(1088, scale=0.02)
    torch.testing.assert_close(fused_ffn(x, w1, b1, w2, b2),
                               ffn_plain(x, w1, b1, w2, b2), **TOL)
    w, b, res = randn(1088, 64, scale=0.03), randn(64), randn(4, 64)
    torch.testing.assert_close(
        linear_res.fused_linear_res_forward(x, w, b, res),
        linear_res_plain(x, w, b, res), **TOL)
    torch.testing.assert_close(fused_mha_forward(q, q, q, kmask, 4)[0],
                               mha_plain(q, q, q, kmask, 4), **TOL)
    xp, dy = randn(2, 20, 1088), randn(2, 5, 1088)
    _close_to_largest(conv_pos.convpos_wgrad(xp, dy, 16, 16),
                      conv_pos.convpos_wgrad_plain(xp, dy, 16, 16))
    assert (fused_ffn.launches, fused_linear_res.launches,
            mha.fused_mha.launches, conv_pos.convpos_wgrad.launches) == \
        tuple(n + 1 for n in before)


# bf16 on the tensor cores: the LN-FFN forward's tiled path and its
# backward (and the decoder FFN's forward, which shares the tiled path) at
# asr-train's 12,288 rows x 256 x 2048, at a padded width (D 200, hidden
# 800) and at D 512; BF16 as DTYPES["bf16"], weight gradients 1e-2 of the
# largest entry
BF16 = DTYPES["bf16"][1]
BF16_SHAPES = {"asr": (12288, 256, 2048), "d200": (3000, 200, 800),
               "d512": (3000, 512, 2048)}


def _plain_ln_ffn_backward(x, ws, dy, cfg):
    """ln_ffn_res_plain_backward; with relu under the kernel's relu mask
    (chip_smoke.kernel_relu_mask: relu' jumps at u = 0, where the
    kernels' and torch's roundings of u fall on either side for some
    entries)."""
    if cfg[0] != "relu":
        return ln_ffn_res_plain_backward(x, *ws[:5], dy, *cfg)
    import chip_smoke
    return chip_smoke.plain_ln_ffn_backward_under(
        x, ws, dy, cfg, chip_smoke.kernel_relu_mask(x, ws, cfg))


def _bf16_ffn_inputs(randn, rows, d, hidden):
    bf = torch.bfloat16
    xav = (6.0 / (d + hidden)) ** 0.5
    ws = [1 + randn(d, scale=0.1), randn(d, scale=0.1),
          randn(d, hidden, scale=xav).to(bf), randn(hidden, scale=0.02).to(bf),
          randn(hidden, d, scale=xav).to(bf), randn(d, scale=0.02).to(bf)]
    return randn(rows, d).to(bf), randn(rows, d).to(bf), ws


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BF16_SHAPES))
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "relu", "silu", "tanh"])
def test_bf16_ln_ffn_runs_on_the_tensor_cores(randn, shape, rate,
                                              activation):
    """The bf16 LN-FFN forward (tiled) and backward against their plain
    versions at BF16 (outputs, dx) and 1e-2 of the largest entry (the
    weight and LN gradients; with relu, the plain backward under the
    kernel's relu mask: `_plain_ln_ffn_backward`), the decoder FFN's forward
    too; each run twice gives the same bits (no atomics, fixed split
    sums)."""
    rows, d, hidden = BF16_SHAPES[shape]
    x, dy, ws = _bf16_ffn_inputs(randn, rows, d, hidden)
    cfg = (activation, rate, rate, 5)
    assert ffn.slice_plan(rows, hidden, 132, d, torch.bfloat16).tiled
    y = fused_ln_ffn_res(x, *ws, *cfg)
    torch.testing.assert_close(y, ln_ffn_res_plain(x, *ws, *cfg), **BF16)
    assert torch.equal(y, fused_ln_ffn_res(x, *ws, *cfg))
    got = fused_ln_ffn_res_backward(x, *ws[:5], dy, *cfg)
    want = _plain_ln_ffn_backward(x, ws, dy, cfg)
    torch.testing.assert_close(got[0], want[0], **BF16)
    for g, w in zip(got[1:], want[1:]):
        _close_to_largest(g, w, 1e-2)
    again = fused_ln_ffn_res_backward(x, *ws[:5], dy, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    yf = fused_ffn(x, *ws[2:], *cfg)
    torch.testing.assert_close(yf, ffn_plain(x, *ws[2:], *cfg), **BF16)
    assert torch.equal(yf, fused_ffn(x, *ws[2:], *cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 40, 300, 511, 512, 4133])
def test_bf16_fused_and_tiled_forwards_agree(randn, monkeypatch, rows):
    """In bf16 the tiled forward (tensor cores) and the fused row-block
    kernel (CUDA cores) agree within BF16, no longer bit for bit; every
    row count, either path forced."""
    x, _, ws = _bf16_ffn_inputs(randn, rows, 256, 2048)
    cfg = ("gelu", 0.1, 0.1, 9)
    outs = []
    for tiled in (False, True):
        plan = ffn.slice_plan

        def forced(*args, tiled=tiled, plan=plan):
            return plan(*args)._replace(tiled=tiled)
        monkeypatch.setattr(ffn, "slice_plan", forced)
        outs.append(fused_ln_ffn_res(x, *ws, *cfg))
        monkeypatch.setattr(ffn, "slice_plan", plan)
    torch.testing.assert_close(outs[1], outs[0], **BF16)
    torch.testing.assert_close(outs[1], ln_ffn_res_plain(x, *ws, *cfg),
                               **BF16)


@pytest.mark.cuda
def test_bf16_products_are_hgmma(randn):
    """The built library's SASS has HGMMA (wgmma) instructions in the
    wgmma_product kernels, and none elsewhere."""
    import shutil
    import subprocess
    from simulst_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    functions = _build.sass_functions(sass)
    wgmma = [n for n in functions if "wgmma_product_kernel" in n]
    assert wgmma and all("HGMMA" in functions[n] for n in wgmma)
    assert not any("HGMMA" in body for n, body in functions.items()
                   if n not in wgmma)


# bf16 rows 2b and 4b on the tensor cores: the FFN backward (all five
# products) and the linear-res backward (dh and dW), against their plain
# versions at BF16 (dx / dh) and 1e-2 of the largest entry (the weight and
# bias gradients), from one row to 12,800 (several K slices of the weight
# products), D 256 and the padded D 200
BF16_BWD_ROWS = [1, 300, 2304, 4133, 12800]
BF16_BWD_WIDTHS = {"d256": (256, 2048), "d200": (200, 800)}


def _plain_ffn_backward(x, ws, dy, cfg):
    """ffn_plain_backward; with relu under the kernel's relu mask
    (chip_smoke.kernel_ffn_relu_mask), as _plain_ln_ffn_backward."""
    if cfg[0] != "relu":
        return ffn_plain_backward(x, *ws[:3], dy, *cfg)
    import chip_smoke
    return chip_smoke.plain_ffn_backward_under(
        x, ws, dy, cfg, chip_smoke.kernel_ffn_relu_mask(x, ws, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(BF16_BWD_WIDTHS))
@pytest.mark.parametrize("rows", BF16_BWD_ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_bf16_ffn_backward_runs_on_the_tensor_cores(randn, activation, rate,
                                                    rows, width):
    """Row 2b in bf16: dx within BF16 of the plain backward, the weight
    and bias gradients within 1e-2 of their largest entry (relu under the
    kernel's relu mask), one launch counted, the same bits twice."""
    d, hidden = BF16_BWD_WIDTHS[width]
    x, dy, ws = _bf16_ffn_inputs(randn, rows, d, hidden)
    ws = ws[2:]
    cfg = (activation, rate, rate, 11)
    before = fused_ffn_backward.launches
    got = fused_ffn_backward(x, *ws[:3], dy, *cfg)
    assert fused_ffn_backward.launches == before + 1
    want = _plain_ffn_backward(x, ws, dy, cfg)
    torch.testing.assert_close(got[0], want[0], **BF16)
    for g, w in zip(got[1:], want[1:]):
        _close_to_largest(g, w, 1e-2)
    again = fused_ffn_backward(x, *ws[:3], dy, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [256, 200])
@pytest.mark.parametrize("rows", BF16_BWD_ROWS)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("period,res_rows", [(0, 0), (200, 192)])
def test_bf16_linear_res_backward_runs_on_the_tensor_cores(
        randn, period, res_rows, rate, rows, width):
    """Row 4b in bf16, gated and ungated: dh within BF16 of the plain
    backward, dW and db within 1e-2 of their largest entry, one launch
    counted, the same bits twice."""
    bf = torch.bfloat16
    h, dy = randn(rows, width).to(bf), randn(rows, width).to(bf)
    w = randn(width, width, scale=width ** -0.5).to(bf)
    cfg = (period, res_rows, rate, 13)
    before = fused_linear_res_backward.launches
    got = fused_linear_res_backward(h, w, dy, *cfg)
    assert fused_linear_res_backward.launches == before + 1
    want = linear_res_plain_backward(h, w, dy, *cfg)
    torch.testing.assert_close(got[0], want[0], **BF16)
    for g, w_ in zip(got[1:], want[1:]):
        _close_to_largest(g, w_, 1e-2)
    again = fused_linear_res_backward(h, w, dy, *cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_bf16_backwards_products_are_hgmma(randn):
    """The FFN backward's and the linear-res backward's bf16 products are
    wgmma_product kernels (their callers' tags in the kernels' names)
    with HGMMA in their SASS."""
    import shutil
    import subprocess
    from simulst_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    wgmma = {n: body for n, body in _build.sass_functions(sass).items()
             if "wgmma_product_kernel" in n}
    for store in ("TagFfnBwd", "TagLinearResBwd"):
        found = [n for n in wgmma if store in n]
        assert found and all("HGMMA" in wgmma[n] for n in found), store


# rows 3b / 3bg in bf16 on the tensor cores (csrc/emformer_attn_bwd.cu):
# (B, ng, nq, D, heads, G, gated): asr-train's q3, the packed gated shapes
# of G 7 and G 3, head dim 128, a padded head dim (50, staged 64), D 512
# with 8 heads and G 16; s2t_emformer_s's unit geometry
BF16_ATTN_SHAPES = {
    "asr-train": (32, 2, 200, 256, 4, 8, False),
    "packed-G7": (16, 4, 175, 256, 4, 7, True),
    "packed-G3": (8, 13, 75, 256, 4, 3, True),
    "hd128": (4, 2, 200, 512, 4, 8, False),
    "hd50": (4, 2, 200, 200, 4, 8, False),
    "d512-8heads": (4, 2, 200, 512, 8, 8, False),
    "G16": (4, 2, 400, 256, 4, 16, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(BF16_ATTN_SHAPES))
def test_bf16_grouped_attention_backward_runs_on_the_tensor_cores(
        randn, shape, rate):
    """Rows 3b / 3bg in bf16 on the tensor-core kernel (its plan): dq within
    BF16 of the plain backward, dk and dv within 1e-2 of their largest
    entry, one launch counted (gated: on gated_launches), the same bits
    twice."""
    from simulst_tpu_torch.ops import emformer_attn as ea
    b, ng, nq, d, heads, G, gated = BF16_ATTN_SHAPES[shape]
    geom = AttnGeom(U=ng * G * 16, seg=16, lc=32, rc=8, max_mem=5, G=G,
                    num_heads=heads)
    assert (geom.ng, geom.nq) == (ng, nq)
    hd = ea.padded_head_dim(d // heads)
    assert ea.bwd_plan(geom, hd, torch.bfloat16) == "tensor_cores"
    bf = torch.bfloat16
    q3, dout = randn(b, ng, nq, d).to(bf), randn(b, ng, nq, d).to(bf)
    k, v = randn(b, geom.tk, d).to(bf), randn(b, geom.tk, d).to(bf)
    gen = torch.Generator().manual_seed(b + G)
    if gated:   # runs of ascending example ids, as packed rows hold them
        import chip_smoke
        gate = chip_smoke.segment_gate(ea, geom, b, gen, "cuda")
        lengths = torch.full((b,), geom.U, dtype=torch.int32, device="cuda")
    else:
        gate = None
        lengths = torch.randint(geom.U // 2, geom.U + 1, (b,),
                                generator=gen).to(torch.int32).cuda()
    args = (q3, k, v, lengths, dout, geom, rate, 17, gate)
    counter = "gated_launches" if gated else "launches"
    before = getattr(emformer_grouped_attention_backward, counter)
    got = emformer_grouped_attention_backward(*args)
    assert getattr(emformer_grouped_attention_backward, counter) == \
        before + 1
    want = grouped_attention_plain_backward(*args)
    torch.testing.assert_close(got[0], want[0], **BF16)
    for g, w in zip(got[1:], want[1:]):
        _close_to_largest(g, w, 1e-2)
    again = emformer_grouped_attention_backward(*args)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


# row 4 in bf16 on the tensor cores: (rows, D_in, D_out, period, residual
# rows): the Emformer out-projection at asr-train (12,800 gated rows) and
# offline (3,200), the MT decoder's 8192 and asr-train's decoder 2,304
# ungated, a padded D_out and D_in
BF16_LR_FWD_SHAPES = {"asr-encoder-12800-gate": (12800, 256, 256, 200, 192),
                      "mt-8192": (8192, 256, 256, 0, 0),
                      "asr-decoder-2304": (2304, 256, 256, 0, 0),
                      "offline-3200-gate": (3200, 256, 256, 200, 192),
                      "dout200": (3200, 256, 200, 200, 192),
                      "din200": (3200, 200, 256, 200, 192)}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", list(BF16_LR_FWD_SHAPES))
def test_bf16_linear_res_forward_runs_on_the_tensor_cores(randn, shape,
                                                          rate):
    """Row 4's bf16 tiled paths (wgmma_product and the epilogue pass)
    within BF16 of the plain forward, one launch counted, the same bits
    twice."""
    rows, din, dout, period, res_rows = BF16_LR_FWD_SHAPES[shape]
    assert linear_res.fwd_uses_tensor_cores(linear_res.fwd_plan(rows),
                                            torch.bfloat16)
    bf = torch.bfloat16
    h, res = randn(rows, din).to(bf), randn(rows, dout).to(bf)
    w = randn(din, dout, scale=din ** -0.5).to(bf)
    b = randn(dout, scale=0.02).to(bf)
    cfg = (period, res_rows, rate, 29)
    before = fused_linear_res.launches
    got = fused_linear_res(h, w, b, res, *cfg)
    assert fused_linear_res.launches == before + 1
    torch.testing.assert_close(got, linear_res_plain(h, w, b, res, *cfg),
                               **BF16)
    assert torch.equal(got, fused_linear_res(h, w, b, res, *cfg))


@pytest.mark.cuda
def test_bf16_attention_backward_and_linear_res_forward_use_tensor_cores(
        randn):
    """The grouped attention's bf16 backward kernels hold HMMA in their
    SASS (mma.sync) and no other kernel of the grouped attention does;
    the linear-res forward's bf16 product is a wgmma_product kernel (its
    caller's tag in its name) with HGMMA."""
    import shutil
    import subprocess
    from simulst_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    funcs = _build.sass_functions(sass)
    tc = [n for n in funcs if "grouped_attn_bwd_tc_kernel" in n]
    assert len(tc) == 8 and all("HMMA" in funcs[n] for n in tc)
    assert not any("HMMA" in body for n, body in funcs.items()
                   if "grouped_attn" in n and n not in tc)
    fwd = [n for n in funcs if "wgmma_product_kernel" in n
           and "TagLinearResFwd" in n]
    assert fwd and all("HGMMA" in funcs[n] for n in fwd)
