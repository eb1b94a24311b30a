"""simulst_tpu_torch Emformer and conv frontend vs the JAX package, CPU.

Weights are the JAX init, bridged to the port; inputs come from seeded
numpy; fp32.  Tolerances: atol 1e-5 for one op, 1e-4 for a stack of layers
(the order of the sums differs).  The offline forward is checked on a
grouped shape (_choose_group > 1: the grouped-attention and
linear-residual kernels' path) and on a ragged one (plain per-segment
attention); the streaming step on a chunk sequence with a partial flush.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.nn import conv as jconv  # noqa: E402
from simulst_tpu.nn import emformer as jemf  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.nn import conv as tconv  # noqa: E402
from simulst_tpu_torch.nn import emformer as temf  # noqa: E402

GEOM = dict(input_dim=32, num_heads=2, ffn_dim=64, num_layers=2,
            left_context=8, right_context=2, segment=4, max_memory=2)
JCFG = jemf.EmformerConfig(**GEOM)
TCFG = temf.EmformerConfig(**GEOM)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def emformer_pair():
    jp = jemf.emformer_init(jax.random.PRNGKey(0), JCFG)
    tp = temf.Emformer(TCFG)
    tp.load_state_dict(load_jax_params(_np_tree(jp)))
    return jp, tp


@pytest.mark.parametrize("U,lengths,grouped", [
    (32, [32, 21], True),    # n = 8 segments, G = 4: grouped kernels' path
    (30, [30, 17], False),   # ragged U: per-segment path
])
def test_emformer_forward_matches_jax(emformer_pair, U, lengths, grouped):
    jp, tp = emformer_pair
    n = -(-U // TCFG.segment)
    assert (temf._choose_group(n, U, TCFG) > 1) == grouped
    x = np.random.RandomState(U).randn(2, U + TCFG.right_context,
                                       TCFG.input_dim).astype(np.float32)
    ref, _ = jemf.emformer_forward(jp, JCFG, jnp.asarray(x),
                                   jnp.asarray(lengths, jnp.int32))
    with torch.no_grad():
        out = temf.emformer_forward(tp, TCFG, torch.from_numpy(x),
                                    torch.tensor(lengths))
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(out[b, :L].numpy(), np.asarray(ref)[b, :L],
                                   atol=1e-4, rtol=1e-4)


def test_emformer_step_sequence_matches_jax(emformer_pair):
    jp, tp = emformer_pair
    S, R = TCFG.segment, TCFG.right_context
    rng = np.random.RandomState(7)
    jstate = jemf.emformer_init_state(JCFG, 2)
    tstate = temf.emformer_init_state(TCFG, 2)
    for valid in (S, S, S, S, S, 3, 1):     # past lc and max_mem, then flush
        x = rng.randn(2, S + R, TCFG.input_dim).astype(np.float32)
        x[:, valid:S] = 0.0
        uv = np.full((2,), valid, np.int32)
        jout, _, jstate = jemf.emformer_step(jp, JCFG, jstate, jnp.asarray(x),
                                             jnp.asarray(uv))
        with torch.no_grad():
            tout = temf.emformer_step(tp, TCFG, tstate, torch.from_numpy(x),
                                      torch.from_numpy(uv))
        np.testing.assert_allclose(tout[:, :valid].numpy(),
                                   np.asarray(jout)[:, :valid],
                                   atol=1e-4, rtol=1e-4)
    for jl, tl in zip(jstate.layers, tstate.layers):
        for name in ("mems", "lc_k", "lc_v"):
            np.testing.assert_allclose(getattr(tl, name).numpy(),
                                       np.asarray(getattr(jl, name)),
                                       atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(tstate.past_length.numpy(),
                                  np.asarray(jstate.past_length))


def test_emformer_without_memory_matches_jax():
    """max_memory = 0: no summaries or memory bank, offline and streaming."""
    geom = dict(GEOM, max_memory=0)
    jcfg, tcfg = jemf.EmformerConfig(**geom), temf.EmformerConfig(**geom)
    jp = jemf.emformer_init(jax.random.PRNGKey(3), jcfg)
    tp = temf.Emformer(tcfg)
    tp.load_state_dict(load_jax_params(_np_tree(jp)))
    rng = np.random.RandomState(8)
    x = rng.randn(2, 32 + 2, 32).astype(np.float32)
    lengths = np.array([32, 19], np.int32)
    ref, _ = jemf.emformer_forward(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(lengths))
    jstate = jemf.emformer_init_state(jcfg, 1)
    tstate = temf.emformer_init_state(tcfg, 1)
    with torch.no_grad():
        out = temf.emformer_forward(tp, tcfg, torch.from_numpy(x),
                                    torch.from_numpy(lengths))
        for b, L in enumerate(lengths):
            np.testing.assert_allclose(out[b, :L].numpy(),
                                       np.asarray(ref)[b, :L],
                                       atol=1e-4, rtol=1e-4)
        for valid in (4, 4, 2):
            xs = rng.randn(1, 6, 32).astype(np.float32)
            xs[:, valid:4] = 0.0
            uv = np.full((1,), valid, np.int32)
            jout, _, jstate = jemf.emformer_step(jp, jcfg, jstate,
                                                 jnp.asarray(xs),
                                                 jnp.asarray(uv))
            tout = temf.emformer_step(tp, tcfg, tstate, torch.from_numpy(xs),
                                      torch.from_numpy(uv))
            np.testing.assert_allclose(tout[:, :valid].numpy(),
                                       np.asarray(jout)[:, :valid],
                                       atol=1e-4, rtol=1e-4)


def test_conv_frontend_matches_jax():
    """Subsampler and conv-pos, offline and chunk by chunk (bridged conv
    layouts and the weight-norm formula)."""
    key = jax.random.PRNGKey(1)
    jsub = jconv.subsampler_init(key, 8, 16, 12)
    jpos = jconv.conv_pos_init(jax.random.PRNGKey(2), 12, 8, 4)
    tsub = tconv.Subsampler(8, 16, 12)
    tsub.load_state_dict(load_jax_params(_np_tree(jsub)))
    tpos = tconv.ConvPos(12, 8, 4)
    tpos.load_state_dict(load_jax_params(_np_tree(jpos)))
    x = np.random.RandomState(3).randn(2, 40, 8).astype(np.float32)
    lengths = np.array([40, 25])

    jy, jl = jconv.subsampler_apply(jsub, jnp.asarray(x), jnp.asarray(lengths))
    jz = jconv.conv_pos_apply(jpos, jy, 4)
    with torch.no_grad():
        ty, tl = tconv.subsampler_apply(tsub, torch.from_numpy(x),
                                        torch.from_numpy(lengths))
        tz = tconv.conv_pos_apply(tpos, ty, 4)
        # streaming: chunks of 8 frames through the caches
        sc = tconv.subsampler_init_cache(tsub, 2)
        pc = tconv.conv_pos_init_cache(tpos, 2, 12)
        steps = []
        for t in range(0, 40, 8):
            y, sc = tconv.subsampler_step(tsub, sc, torch.from_numpy(x[:, t:t + 8]))
            z, pc = tconv.conv_pos_step(tpos, pc, y, 4)
            steps.append(z)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), np.asarray(jz),
                               atol=1e-5, rtol=1e-5)
