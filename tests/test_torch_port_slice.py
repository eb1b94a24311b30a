"""The s2t_emformer serving slice of simulst_tpu_torch vs the JAX package,
at a small config (2 encoder and 2 decoder layers, width 32), CPU.

JAX init bridged to the port; seeded numpy features; fp32.  Covers the
offline encoder and CTC head (grouped-attention shape), the streaming
stepper's chunk protocol chunk by chunk, the repo's golden rule
(streaming == offline) inside the port, the teacher-forced model, and
decode_batch tokens for greedy and beam search.  Tolerance 1e-4 for stacks; tokens must be equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.cli import generate as jgen  # noqa: E402
from simulst_tpu.decode.beam import BeamConfig as JBeam  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu_torch.cli import generate as tgen  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.decode.beam import BeamConfig as TBeam  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=32,
             ffn_dim=64, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=64, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True)
T = 128          # feature frames: U = 32 post-subsample, 8 segments, G = 4
# streaming chunk plan: (seg+rc)*4 first, then seg*4, then the flush
CHUNKS = [24, 16, 16, 16, 16, 16, 16, 8]


@pytest.fixture(scope="module")
def models():
    jcfg = js2t.S2TEmformerConfig(**SMALL, dropout=0.0, attention_dropout=0.0,
                                  activation_dropout=0.0)
    jmodel = js2t.S2TEmformerModel(jcfg)
    jp = jmodel.init(jax.random.PRNGKey(0))
    tmodel = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**SMALL),
                                   device="cpu")
    tmodel.load_state_dict(load_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)))
    return jmodel, jp, tmodel


def _feats(seed, b):
    return np.random.RandomState(seed).randn(b, T, 8).astype(np.float32)


def test_encoder_forward_matches_jax(models):
    jmodel, jp, tmodel = models
    feats, lengths = _feats(1, 2), np.array([T, 90])
    ref = js2t.encoder_forward(jp["encoder"], jmodel.cfg, jnp.asarray(feats),
                               jnp.asarray(lengths))
    with torch.no_grad():
        out = ts2t.encoder_forward(tmodel.encoder, tmodel.cfg,
                                   torch.from_numpy(feats),
                                   torch.from_numpy(lengths))
    np.testing.assert_array_equal(out.lengths.numpy(), np.asarray(ref.lengths))
    for b, L in enumerate(np.asarray(ref.lengths)):
        for name in ("encoder_out", "ctc_logits"):
            np.testing.assert_allclose(getattr(out, name)[b, :L].numpy(),
                                       np.asarray(getattr(ref, name))[b, :L],
                                       atol=1e-4, rtol=1e-4, err_msg=name)


def test_stepper_matches_jax_and_port_offline(models):
    jmodel, jp, tmodel = models
    feats = _feats(2, 1)
    step = ts2t.make_encoder_stepper(tmodel.encoder, tmodel.cfg)
    tstate = ts2t.encoder_init_state(tmodel.encoder, tmodel.cfg, 1)
    jstate = js2t.encoder_init_state(jp["encoder"], jmodel.cfg, 1)
    outs, t = [], 0
    for i, c in enumerate(CHUNKS):
        finish = i == len(CHUNKS) - 1
        jout, jstate = js2t.encoder_step(jp["encoder"], jmodel.cfg, jstate,
                                         jnp.asarray(feats[:, t:t + c]),
                                         finish=finish)
        with torch.no_grad():
            tout, tstate = step(tstate, torch.from_numpy(feats[:, t:t + c]),
                                finish=finish)
        assert tstate.carry_len == jstate.carry_len
        np.testing.assert_allclose(tout.encoder_out.numpy(),
                                   np.asarray(jout.encoder_out),
                                   atol=1e-4, rtol=1e-4)
        outs.append(tout.encoder_out)
        t += c
    with torch.no_grad():
        off = ts2t.encoder_forward(tmodel.encoder, tmodel.cfg,
                                   torch.from_numpy(feats), torch.tensor([T]))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               off.encoder_out.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("chunks", [
    [24, 16, 16, 16, 8],     # standard protocol, partial flush
    [24, 16, 16, 16, 16],    # exact multiple
    [80, 0],                 # one oversized chunk, then an empty flush
    [24, 16, 4],             # flush shorter than rc
])
def test_port_streaming_equals_offline(models, chunks):
    """The golden rule on ragged lengths (per-segment attention path)."""
    _, _, tmodel = models
    feats = torch.from_numpy(_feats(6, 1)[:, :sum(chunks)])
    step = ts2t.make_encoder_stepper(tmodel.encoder, tmodel.cfg)
    state = ts2t.encoder_init_state(tmodel.encoder, tmodel.cfg, 1)
    outs, t = [], 0
    with torch.no_grad():
        for i, c in enumerate(chunks):
            out, state = step(state, feats[:, t:t + c],
                              finish=i == len(chunks) - 1)
            outs.append(out.encoder_out)
            t += c
        off = ts2t.encoder_forward(tmodel.encoder, tmodel.cfg, feats,
                                   torch.tensor([t]))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(),
                               off.encoder_out.numpy(), atol=1e-4, rtol=1e-4)


def test_model_forward_matches_jax(models):
    jmodel, jp, tmodel = models
    feats, lengths = _feats(3, 2), np.array([T, 100])
    prev = np.random.RandomState(3).randint(3, 40, size=(2, 6))
    prev[:, 0] = 2
    ref, _ = jmodel.forward(jp, jnp.asarray(feats), jnp.asarray(lengths),
                            jnp.asarray(prev))
    with torch.no_grad():
        out, _ = tmodel(torch.from_numpy(feats), torch.from_numpy(lengths),
                        torch.from_numpy(prev))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# Seed 5 was picked so that no near-tie can flip a token: the top-2 logit
# gap of every greedy step stays above 1, and the gap between neighbouring
# ranked candidates at every beam top-k cut above 3e-3, well over the
# port's 1e-4 stack tolerance (seeds 4 and 6 have beam gaps under 1e-3).
@pytest.mark.parametrize("beam", [1, 3])
def test_decode_batch_tokens_match_jax(models, beam):
    jmodel, jp, tmodel = models
    batch = {"feats": _feats(5, 2), "feat_lengths": np.array([T, 76])}
    kw = dict(beam_size=beam, max_len=12)
    jtok, jlen = jgen.decode_batch(jmodel, jp, batch, JBeam(**kw))
    with torch.no_grad():
        ttok, tlen = tgen.decode_batch(tmodel, batch, TBeam(**kw))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))


def test_decode_batch_rejects_unported_models():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tgen.decode_batch(object(), {"feats": np.zeros((1, 8, 8))}, TBeam())
