"""Offline decoding of the MMA and CIF models in simulst_tpu_torch vs the
JAX package, on the CPU: `decode_batch` (the encoder once, then greedy or
beam search over `mma_decoder_step` offline / `cif_decoder_step` over the
fired CIF features) token for token at B = 2, beam 1 and beam 3;
`decode_batch_ensemble` of an MMA and a CIF model; `--prefix-size` and
`--unk-penalty` through `BeamConfig` and `prefix_tokens`.

Small models: 2 + 2 layers, width 16, 2 heads, FFN 32, vocab 24, 64
feature frames (16 after subsampling), the second example 44 frames; MMA
with infinite lookback and fixed pre-decision ratio 2.  JAX init bridged
to the port (compat/jax_bridge.load_jax_params), the decoder's final
layer norm scale drawn at random (N(0, 9)) so that greedy tokens do not
just repeat the previous one through the shared embedding, and for MMA
EOS's row shrunk 10x so that EOS does not win every step (CIF ends by its
own overshoot bias); fp32 with jax_default_matmul_precision float32
(tests/conftest.py); no dropout.  Tokens and lengths must be equal.  The
seeds were picked so that no near-tie can flip a token: on the port's
side, the top-2 logit gap of every greedy step stays above 1e-2 and the
gap between neighbouring ranked candidates at every beam top-k cut above
2e-3, twenty times the 1e-4 tolerance of the port's stacks (its logits
differ from JAX's by about 1e-6 here).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.cli import generate as jgen  # noqa: E402
from simulst_tpu.decode.beam import BeamConfig as JBeam  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu_torch.cli import generate as tgen  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.decode.beam import BeamConfig as TBeam  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402

SPEECH = dict(vocab_size=24, input_feat=8, conv_channels=16, embed_dim=16,
              ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
              decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
              left_context=32, right_context=8, max_memory=2,
              max_target_positions=64, dropout=0.0, attention_dropout=0.0,
              activation_dropout=0.0, no_scale_embedding=True)
MMA = dict(SPEECH, simul_attn_type="infinite_lookback_fixed_pre_decision",
           fixed_pre_decision_ratio=2)
T, MAX_LEN = 64, 8
FAMILIES = {"mma": (jmma.MMAModel, jmma.MMAConfig, tmma.MMAModel,
                    tmma.MMAConfig, MMA, 0.1),
            "cif": (jcif.CIFModel, jcif.CIFConfig, tcif.CIFModel,
                    tcif.CIFConfig, SPEECH, 1.0)}


def _pair(kind):
    """(JAX model, its params, the port model with the same weights)."""
    jmodel_cls, jcfg_cls, tmodel_cls, tcfg_cls, kw, eos_scale = \
        FAMILIES[kind]
    jmodel = jmodel_cls(jcfg_cls(**kw))
    jp = jmodel.init(jax.random.PRNGKey(0))
    dec = jp["decoder"]
    dec["embed_tokens"]["weight"] = dec["embed_tokens"]["weight"].at[
        2].multiply(eos_scale)
    dec["layer_norm"]["scale"] = jnp.asarray(
        np.random.RandomState(3).randn(16).astype(np.float32) * 3.0)
    tmodel = tmodel_cls(tcfg_cls(**kw), device="cpu")
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    return jmodel, jp, tmodel.eval()


@pytest.fixture(scope="module")
def models():
    return {kind: _pair(kind) for kind in FAMILIES}


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {"feats": rng.randn(2, T, 8).astype(np.float32),
            "feat_lengths": np.array([T, 44])}


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("kind,seed", [("mma", 0), ("cif", 0)])
def test_decode_batch_matches_jax(models, kind, seed, beam):
    jmodel, jp, tmodel = models[kind]
    batch, kw = _batch(seed), dict(beam_size=beam, max_len=MAX_LEN)
    want = jgen.decode_batch(jmodel, jp, batch, JBeam(**kw))
    with torch.no_grad():
        got = tgen.decode_batch(tmodel, batch, TBeam(**kw))
    _same(got, want)


def test_decode_batch_ensemble_matches_jax(models):
    """An MMA and a CIF model, their per-step probabilities averaged, beam
    3 (batch seed 1: seed 0's averaged candidates come within 1.4e-4)."""
    batch, cfg = _batch(1), dict(beam_size=3, max_len=MAX_LEN)
    want = jgen.decode_batch_ensemble(
        [models[k][0] for k in FAMILIES], [models[k][1] for k in FAMILIES],
        batch, JBeam(**cfg))
    with torch.no_grad():
        got = tgen.decode_batch_ensemble([models[k][2] for k in FAMILIES],
                                         batch, TBeam(**cfg))
    _same(got, want)


def test_prefix_and_unk_penalty_match_jax(models):
    """--prefix-size 2 (the second row's prefix one token, PAD-padded) at
    beam 3 on the CIF model and at beam 1 on the MMA model, and
    --unk-penalty 0.5 at beam 1 on the CIF model."""
    batch = _batch(0)
    prefix = np.array([[7, 11], [5, 1]])
    for kind, beam in (("cif", 3), ("mma", 1)):
        jmodel, jp, tmodel = models[kind]
        cfg = dict(beam_size=beam, max_len=MAX_LEN)
        want = jgen.decode_batch(jmodel, jp, batch, JBeam(**cfg),
                                 prefix_tokens=jnp.asarray(prefix))
        with torch.no_grad():
            got = tgen.decode_batch(tmodel, batch, TBeam(**cfg),
                                    prefix_tokens=prefix)
        _same(got, want)
        assert got[0][0, :2].tolist() == [7, 11] and got[0][1, 0] == 5
    jmodel, jp, tmodel = models["cif"]
    cfg = dict(beam_size=1, max_len=MAX_LEN, unk_penalty=0.5)
    want = jgen.decode_batch(jmodel, jp, batch, JBeam(**cfg))
    with torch.no_grad():
        got = tgen.decode_batch(tmodel, batch, TBeam(**cfg))
    _same(got, want)
