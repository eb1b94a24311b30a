"""simulst_tpu_torch decoder, incremental attention and KV cache vs the JAX
package, CPU.  JAX init bridged to the port, seeded numpy inputs, fp32;
atol 1e-5 per op, 1e-4 for the layer stack."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.nn import attention as jattn  # noqa: E402
from simulst_tpu.nn import transformer as jtfm  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.nn import attention as tattn  # noqa: E402
from simulst_tpu_torch.nn import transformer as ttfm  # noqa: E402

DEC = dict(vocab_size=23, embed_dim=32, ffn_dim=64, num_layers=2,
           num_heads=2, encoder_embed_dim=32, max_target_positions=16)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def decoder_pair():
    jcfg, tcfg = jtfm.DecoderConfig(**DEC), ttfm.DecoderConfig(**DEC)
    jp = jtfm.decoder_init(jax.random.PRNGKey(0), jcfg)
    tp = ttfm.Decoder(tcfg, device="cpu")
    tp.load_state_dict(load_jax_params(_np_tree(jp)))
    return jcfg, jp, tcfg, tp


def _encoder(rng, b=3, s=11):
    enc = rng.randn(b, s, 32).astype(np.float32)
    valid = np.arange(s)[None, :] < np.array([11, 7, 3])[:, None]
    return enc, valid


def test_sinusoidal_table_matches_jax():
    np.testing.assert_allclose(ttfm.sinusoidal_table(20, 32, 1).numpy(),
                               np.asarray(jtfm.sinusoidal_table(20, 32, 1)),
                               atol=1e-6)


def test_decoder_step_sequence_matches_jax(decoder_pair):
    jcfg, jp, tcfg, tp = decoder_pair
    rng = np.random.RandomState(0)
    enc, valid = _encoder(rng)
    toks = rng.randint(0, DEC["vocab_size"], size=(6, 3))
    jstate = jtfm.decoder_init_state(jcfg, 3, 8)
    tstate = ttfm.decoder_init_state(tcfg, 3, 8)
    for tok in toks:
        jl, jstate = jtfm.decoder_step(jp, jcfg, jstate, jnp.asarray(tok),
                                       jnp.asarray(enc), jnp.asarray(valid))
        with torch.no_grad():
            tl, tstate = ttfm.decoder_step(tp, tcfg, tstate,
                                           torch.from_numpy(tok),
                                           torch.from_numpy(enc),
                                           torch.from_numpy(valid))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    for jc, tc in zip(jstate.caches, tstate.caches):
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=1e-5)
        np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_mha_step_and_rollback_match_jax(decoder_pair):
    _, jp, _, tp = decoder_pair
    jsa, tsa = jp["layers"][0]["self_attn"], tp.layers[0].self_attn
    rng = np.random.RandomState(1)
    jc = jattn.kv_cache_init(2, 2, 6, 16)
    tc = tattn.kv_cache_init(2, 2, 6, 16)
    for t in range(5):
        q = rng.randn(2, 1, 32).astype(np.float32)
        jy, jc = jattn.mha_step(jsa, jc, jnp.asarray(q), 2)
        with torch.no_grad():
            ty, tc = tattn.mha_step(tsa, tc, torch.from_numpy(q), 2)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        if t == 2:   # a READ rollback: drop the last two steps
            jc, tc = jattn.kv_cache_rollback(jc, 2), tattn.kv_cache_rollback(tc, 2)
            np.testing.assert_array_equal(tc.length.numpy(),
                                          np.asarray(jc.length))


def test_decoder_forward_matches_jax(decoder_pair):
    jcfg, jp, tcfg, tp = decoder_pair
    rng = np.random.RandomState(2)
    enc, valid = _encoder(rng)
    prev = rng.randint(3, DEC["vocab_size"], size=(3, 5))
    prev[:, 0] = 2
    prev[2, 3:] = 1                                  # padded target
    ref = jtfm.decoder_forward(jp, jcfg, jnp.asarray(prev), jnp.asarray(enc),
                               jnp.asarray(valid))
    with torch.no_grad():
        out = ttfm.decoder_forward(tp, tcfg, torch.from_numpy(prev),
                                   torch.from_numpy(enc),
                                   torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
