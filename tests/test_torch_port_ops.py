"""simulst_tpu_torch ops vs the JAX package, on the CPU.

Each kernel's plain PyTorch version (what a kernel wrapper runs on a CPU
tensor) is held against the JAX function as the JAX package's own CPU
tests run it: the XLA references for the FFN blocks, interpret mode for
the linear-residual and grouped-attention Pallas kernels.  Inputs come
from seeded numpy; fp32 throughout, tolerance atol 1e-5 (only the order
of the sums differs).  The CUDA kernels themselves are held against these
plain versions on the card by tests/test_torch_port_cuda.py and
chip_smoke.py.
"""
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.data.features import utterance_cmvn as cmvn_np  # noqa: E402
from simulst_tpu.ops import fbank as jfb  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import AttnGeom as JGeom  # noqa: E402
from simulst_tpu.ops.emformer_attn_pallas import \
    emformer_grouped_attention as j_grouped_attention  # noqa: E402
from simulst_tpu.ops.ffn_pallas import (ffn_reference,  # noqa: E402
                                        ln_ffn_res_reference)
from simulst_tpu.ops.linear_res_pallas import fused_linear_drop_res  # noqa: E402
from simulst_tpu_torch.ops import _build, ffn, linear_res, mha  # noqa: E402
from simulst_tpu_torch.ops import fbank as tfb  # noqa: E402
from simulst_tpu_torch.ops.emformer_attn import (  # noqa: E402
    SMEM_LIMIT, AttnGeom, _fitting_unit, emformer_grouped_attention,
    group_gather_indices, group_row_seg, grouped_attention_plain, unit_shape)
from simulst_tpu_torch.ops.ffn import (ffn_plain, fused_ffn,  # noqa: E402
                                       fused_ln_ffn_res, ln_ffn_res_plain)
from simulst_tpu_torch.ops.linear_res import (fused_linear_res,  # noqa: E402
                                              linear_res_plain)

ATOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _ffn_weights(rng, d, h):
    return (_rand(rng, d), _rand(rng, d, scale=0.1), _rand(rng, d, h, scale=0.1),
            _rand(rng, h, scale=0.1), _rand(rng, h, d, scale=0.1),
            _rand(rng, d, scale=0.1))


@pytest.mark.parametrize("rows", [1, 24, 77])
def test_ln_ffn_res_plain_matches_jax(rows):
    rng = np.random.RandomState(rows)
    x = _rand(rng, rows, 64)
    g, b, w1, b1, w2, b2 = _ffn_weights(rng, 64, 256)
    ref = ln_ffn_res_reference(*map(jnp.asarray, (x, g, b, w1, b1, w2, b2)),
                               None, None)
    args = [torch.from_numpy(a) for a in (x, g, b, w1, b1, w2, b2)]
    for fn in (ln_ffn_res_plain, fused_ln_ffn_res):
        np.testing.assert_allclose(fn(*args).numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("rows", [1, 40])
def test_ffn_plain_matches_jax(rows):
    rng = np.random.RandomState(10 + rows)
    x = _rand(rng, rows, 64)
    _, _, w1, b1, w2, b2 = _ffn_weights(rng, 64, 256)
    ref = ffn_reference(*map(jnp.asarray, (x, w1, b1, w2, b2)), None, None)
    args = [torch.from_numpy(a) for a in (x, w1, b1, w2, b2)]
    for fn in (ffn_plain, fused_ffn):
        np.testing.assert_allclose(fn(*args).numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("period,res_rows", [(0, 0), (50, 46)])
def test_linear_res_plain_matches_pallas_interpret(period, res_rows):
    rng = np.random.RandomState(period)
    h, res = _rand(rng, 150, 128), _rand(rng, 150, 128)
    w, b = _rand(rng, 128, 128, scale=0.05), _rand(rng, 128, scale=0.05)
    ref = fused_linear_drop_res(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(res), jnp.array([0], jnp.int32),
                                0.0, period, res_rows, True)
    args = [torch.from_numpy(a) for a in (h, w, b, res)]
    for fn in (linear_res_plain, fused_linear_res):
        np.testing.assert_allclose(fn(*args, period, res_rows).numpy(),
                                   np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("rows,period,res_rows", [
    (1, 0, 0),       # the streaming step's decoder epilogue
    (40, 0, 0),      # the decoder step's, 8 utterances x beam 5
    (40, 25, 24)])   # a gate inside 40 rows
def test_linear_res_plain_matches_pallas_interpret_at_step_rows(
        rows, period, res_rows):
    """The decoder steps' row counts, which the CUDA forward runs on its
    row kernel (fwd_plan), against the Pallas kernel in interpret mode."""
    rng = np.random.RandomState(100 + rows + period)
    h, res = _rand(rng, rows, 128), _rand(rng, rows, 128)
    w, b = _rand(rng, 128, 128, scale=0.05), _rand(rng, 128, scale=0.05)
    ref = fused_linear_drop_res(jnp.asarray(h), jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(res), jnp.array([0], jnp.int32),
                                0.0, period, res_rows, True)
    args = [torch.from_numpy(a) for a in (h, w, b, res)]
    for fn in (linear_res_plain, fused_linear_res):
        np.testing.assert_allclose(fn(*args, period, res_rows).numpy(),
                                   np.asarray(ref), atol=ATOL, rtol=1e-5)


# rows -> the CUDA forward's path: the decoder and streaming steps on the
# row kernel, the ASR decoder's and the offline encoder's on 128 x 64
# tiles, the MT and ASR encoder's train shapes on 128 x 128 tiles
@pytest.mark.parametrize("rows,path", [
    (1, "rows"),       # streaming decoder step
    (24, "rows"),
    (40, "rows"),      # offline decoder step, 8 utterances x beam 5
    (linear_res.TILED_MIN_ROWS - 1, "rows"),
    (linear_res.TILED_MIN_ROWS, "tiled"),
    (2304, "tiled"),   # ASR decoder epilogues, 32 x 72
    (3200, "tiled"),   # offline encoder out-projection, 8 x 2 x 200
    (linear_res.WIDE_MIN_ROWS - 1, "tiled"),
    (8192, "wide"),    # MT decoder epilogues, 64 x 128
    (12800, "wide")])  # ASR encoder out-projection, 32 x 2 x 200
def test_linear_res_fwd_plan(rows, path):
    assert (linear_res.TILED_MIN_ROWS, linear_res.WIDE_MIN_ROWS) == \
        (1536, 8192)
    assert linear_res.fwd_plan(rows) == path
    assert sorted(linear_res.FWD_PATHS.values()) == [0, 1, 2]


# Tq -> the CUDA forward's kernel: the decoder step's one query row on the
# decode kernel, every teacher-forced shape on the 64-row tiles
@pytest.mark.parametrize("tq,path", [
    (1, "decode"),     # decoder step cross-attention (and a cache's)
    (mha.DECODE_MAX_TQ, "decode"),
    (mha.DECODE_MAX_TQ + 1, "tiles"),
    (50, "tiles"),
    (72, "tiles"),     # ASR decoder, 64-token targets padded to 72
    (128, "tiles")])   # MT, 128 tokens
def test_mha_fwd_plan(tq, path):
    assert mha.DECODE_MAX_TQ == 2
    assert mha.fwd_plan(tq) == path
    assert mha.FWD_PATHS[path] in (0, 1)


def test_grouped_attention_plain_matches_pallas_interpret():
    geo = dict(U=64, seg=4, lc=8, rc=2, max_mem=3, G=4, num_heads=2)
    jg, tg = JGeom(**geo), AttnGeom(**geo)
    assert (tg.ng, tg.nq, tg.tk) == (jg.ng, jg.nq, jg.tk)
    rng = np.random.RandomState(3)
    b, d = 3, 32
    q3 = _rand(rng, b, tg.ng, tg.nq, d)
    k, v = _rand(rng, b, tg.tk, d), _rand(rng, b, tg.tk, d)
    lengths = np.array([64, 41, 9], np.int32)
    ref = j_grouped_attention(jnp.asarray(q3), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lengths), jnp.array([0], jnp.int32),
                              None, jg, 0.0, True)
    args = [torch.from_numpy(a) for a in (q3, k, v, lengths)]
    for fn in (grouped_attention_plain, emformer_grouped_attention):
        np.testing.assert_allclose(fn(*args, tg).numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=1e-5)


# (U, seg, lc, rc, max_mem, G): s2t_emformer_s's geometry, its packed
# rows (28 segments, G 7), and the card tests' stressed segment units (rc >
# seg, lc not a multiple of seg, one memory slot, G 2 and 3)
UNIT_GEOMS = [(256, 16, 32, 8, 5, 8), (448, 16, 32, 8, 5, 7),
              (128, 16, 32, 8, 5, 4), (48, 8, 16, 12, 5, 2),
              (96, 16, 20, 8, 5, 3), (128, 16, 32, 8, 1, 4)]


@pytest.mark.parametrize("U,seg,lc,rc,max_mem,G", UNIT_GEOMS)
def test_unit_shape_holds_every_segment_s_context(U, seg, lc, rc, max_mem,
                                                  G):
    """The kernels size a segment unit's tiles and shared memory from
    unit_shape: its columns must hold every slot a segment's rows see
    (group_gather_indices' `allowed`), and the most any one row sees; its
    rows those of a segment; and both blocks fit the card."""
    geom = AttnGeom(U=U, seg=seg, lc=lc, rc=rc, max_mem=max_mem, G=G,
                    num_heads=4)
    unit = unit_shape(geom, 64)
    allowed = group_gather_indices(U, seg, lc, rc, max_mem, G)[3]
    row_seg = group_row_seg(seg, rc, G)
    assert unit.cols == allowed.sum(axis=1).max()
    assert np.bincount(row_seg).tolist() == [unit.rows] * G
    for i in range(G):
        assert allowed[row_seg == i].any(axis=0).sum() == unit.cols
    assert max(unit.fwd_smem, unit.bwd_smem) <= SMEM_LIMIT
    assert _fitting_unit("attn", geom, 64, backward=True) == (unit,
                                                              unit.bwd_smem)


def test_unit_shape_refuses_a_block_beyond_shared_memory():
    """G 16 puts 436 context slots in a group: the backward's dK / dV
    accumulators of 64 features no longer fit a block, so they hold 32 and
    the walks run twice; G 64 (1,636 slots) does not fit even at the
    smallest split, and the wrapper says so."""
    geom = AttnGeom(U=512, seg=16, lc=32, rc=8, max_mem=5, G=16, num_heads=4)
    assert _fitting_unit("attn", geom, 64)[1] <= SMEM_LIMIT
    assert _fitting_unit("attn", geom, 64, backward=True)[0].acc_features == 32
    big = AttnGeom(U=2048, seg=16, lc=32, rc=8, max_mem=5, G=64, num_heads=4)
    with pytest.raises(ValueError, match="shared memory"):
        _fitting_unit("attn", big, 64, backward=True)


def test_fbank_batch_matches_np():
    rng = np.random.RandomState(0)
    wavs = (rng.randn(2, 8000) * 0.05).astype(np.float32) * 2 ** 15
    np.testing.assert_array_equal(tfb.povey_window(400), jfb.povey_window(400))
    np.testing.assert_array_equal(tfb.mel_banks(80, 512, 16000.0),
                                  jfb.mel_banks(80, 512, 16000.0))
    assert tfb.frame_params() == jfb.frame_params()
    assert [tfb.num_frames(n) for n in (0, 399, 400, 8000)] == \
        [jfb.num_frames(n) for n in (0, 399, 400, 8000)]
    out = tfb.fbank_batch(torch.from_numpy(wavs)).numpy()
    for i in range(2):
        np.testing.assert_allclose(out[i], jfb.fbank_np(wavs[i]),
                                   rtol=2e-5, atol=2e-4)


def test_utterance_cmvn_matches_np():
    feats = _rand(np.random.RandomState(4), 50, 8, scale=3.0) + 1.0
    np.testing.assert_allclose(
        tfb.utterance_cmvn(torch.from_numpy(feats)).numpy(), cmvn_np(feats),
        atol=ATOL, rtol=1e-5)


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, simulst_tpu_torch\n"
            "for m in pkgutil.walk_packages(simulst_tpu_torch.__path__,\n"
            "                               'simulst_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'simulst_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# rows, 64 x 64 output tiles, K slices on a 132-SM H100: the weight-gradient
# products sum each slice apart and then add the slices, so these slices fix
# the backwards' bits, whatever tiles the products compute in
@pytest.mark.parametrize("rows,tiles,splits", [
    (8192, 128, 3),     # the MT decoder FFN backward (chip_smoke phase 5)
    (8192, 16, 17),     # the MT linear-res backward, 256 x 256 (phase 5)
    (12800, 16, 17),    # the ASR Emformer out-projection's, 32 x 2 x 200
    (2304, 16, 9),      # the ASR decoder's linear-res backward, 32 x 72
    (437, 16, 1),       # the card tests' linear-res backward
    (12288, 128, 3),    # the ASR LN-FFN backward, 32 x 384 rows (phase 7)
    (10752, 128, 3),    # packed: 16 rows of 28 x (8 + 16) (phase 15)
    (7488, 128, 3),     # packed mixed batch: 8 rows of 39 x 24 (phase 15)
    (12325, 128, 3),    # the card tests' ragged row counts
    (4133, 128, 3),
    (300, 128, 1),
    (1, 128, 1)])
def test_k_splits_keep_the_weight_products_slices(monkeypatch, rows, tiles,
                                                  splits):
    monkeypatch.setattr(ffn, "_sm_count", lambda index: 132)
    assert ffn.k_splits(rows, tiles, torch.device("cpu")) == splits


# rows, hidden, SMs, and the forward's hidden splits as the fused row-block
# kernel took them before the tiled path existed: the tiled path's output
# product sums the same K slices, so both paths give those bits; the
# backwards keep k_splits
@pytest.mark.parametrize("rows,hidden,sms,splits", [
    (1, 2048, 132, 32),      # decoder step, one utterance
    (24, 2048, 132, 32),     # streaming chunk (rc 8 + seg 16)
    (40, 2048, 132, 32),     # decoder step, 8 utterances x beam 5
    (300, 2048, 132, 16),
    (511, 2048, 132, 16),    # either side of TILED_MIN_ROWS
    (512, 2048, 132, 16),
    (513, 2048, 132, 8),
    (3072, 2048, 132, 2),    # offline encoder, 8 x 384 rows
    (4133, 2048, 132, 2),
    (8192, 2048, 132, 1),    # the MT decoder FFN
    (12288, 2048, 132, 1),   # the ASR LN-FFN, 32 x 384 rows
    (1, 1024, 132, 16),
    (40, 192, 132, 1),       # 3 chunks: no even split
    (3072, 2048, 78, 1),
    (300, 2048, 114, 16)])
def test_ffn_slice_plan_keeps_the_kernels_slices(monkeypatch, rows, hidden,
                                                 sms, splits):
    plan = ffn.slice_plan(rows, hidden, sms, 256)
    assert plan.splits == splits
    assert (hidden // plan.splits) % ffn.HIDDEN_CHUNK == 0
    assert plan.splits * (hidden // plan.splits) == hidden
    assert plan.tiled == (rows >= ffn.TILED_MIN_ROWS)
    monkeypatch.setattr(ffn, "_sm_count", lambda index: sms)
    tiles = (256 // ffn.WGRAD_TILE) * (hidden // ffn.WGRAD_TILE)
    assert plan.bwd_splits == ffn.k_splits(rows, tiles, torch.device("cpu"))


def test_aligned_copies_only_a_misaligned_view():
    base = torch.arange(65, dtype=torch.float32)
    assert _build.aligned(base) is base
    view = base[1:].view(8, 8)
    assert view.data_ptr() % 16
    out = _build.aligned(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
