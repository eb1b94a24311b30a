"""Batched streaming of simulst_tpu_torch vs the JAX package and vs its own
B = 1 sessions, on the CPU: `encoder_step` with per-example `feat_valid`
on the final chunk (against JAX's, and against each example streamed
alone, unpadded, one of them with no new frames in its final chunk),
`cif_layer_step` with `x_valid`, the fused CIF and MMA steps with
`n_valid`, and `evaluate_batched` (B = 3, lock-step within chunk-count
buckets) against the port's B = 1 `evaluate` and JAX's
`evaluate_batched` on the same weights; with a token buffer that fills,
against JAX's B = 1 `evaluate` (JAX's batched evaluator gives the last
word of a full buffer the bucket's end, the port the filling chunk's
delay, as both B = 1 sessions do).

Small models: width 16, 1 encoder and 2 decoder layers, 2 heads, FFN 32,
vocab 24, 80 fbank features, segment 4 / left context 8 / right context 2
frames after subsampling; JAX init bridged to the port
(compat/jax_bridge.load_jax_params), the final layer norm's scale drawn at
random (N(0, 9)) and EOS's embedding row shrunk so that greedy decoding
writes more than EOS; the CIF layer at width 64 as in
tests/test_torch_port_cif.py.  fp32 with jax_default_matmul_precision
float32 (tests/conftest.py).  Tolerances: encoder outputs atol 1e-4,
rtol 1e-4 (port vs JAX; the port's batched flush vs its B = 1 runs);
the CIF layer's fired features atol 1e-5 plus what a cumsum's ulp moves
(tests/test_torch_port_cif.py's `_tol`), its fire counts exactly, every
running alpha sum more than 1e-3 from a multiple of beta; tokens, words
and lengths exactly; delays atol 1e-6.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.data.vocab import Vocabulary as JVocabulary  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mma as jmma  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.stream import agents as jagents  # noqa: E402
from simulst_tpu.stream import evaluator as jeval  # noqa: E402
from simulst_tpu.stream import fused as jfused  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data.vocab import SPECIALS, Vocabulary  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.stream import agents as tagents  # noqa: E402
from simulst_tpu_torch.stream import evaluator as teval  # noqa: E402
from simulst_tpu_torch.stream import fused as tfused  # noqa: E402

EOS = 2
PIECES = ["▁the", "▁cat", "s", "▁sat", "▁on", "▁a", "ma", "t", "▁dog",
          "▁ran", "ning", "▁far", "▁away", "▁and", "▁back", "ed", "▁home",
          "ly", "▁big", "ger"]
SYMBOLS = SPECIALS + PIECES                       # 24 ids
SMALL = dict(vocab_size=24, input_feat=80, conv_channels=16, embed_dim=16,
             ffn_dim=32, encoder_layers=1, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=128, dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0, no_scale_embedding=True)
WAITK = dict(simul_attn_type="waitk_fixed_pre_decision",
             fixed_pre_decision_ratio=2, waitk_lagging=2)
# MMA's learned heads: infinite lookback, p_choose from the energies
MMA_KINDS = {"waitk": WAITK, "ilk": dict(simul_attn_type="infinite_lookback")}
# 0.5 s (a bucket of its own), 0.9 and 1.0 s (one bucket, final chunks of
# other sizes, one with no new fbank frame), 1.3 s, 1.0 s
SECONDS = [0.5, 0.9, 1.0, 1.3, 1.0]
TOL = dict(atol=1e-4, rtol=1e-4)


def _wave(seed, n):
    """Seeded tones and noise in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    wav = sum(a * np.sin(2 * np.pi * f * t) for a, f in
              zip(rng.uniform(0.05, 0.3, 3), rng.uniform(100, 3000, 3)))
    return np.clip(wav + 0.05 * rng.randn(n), -1, 1).astype(np.float32)


def _audios():
    return [_wave(20 + i, int(16000 * s)) for i, s in enumerate(SECONDS)]


def _pair(kind, seed=0, eos_scale=0.1):
    """(JAX model, JAX params, port model) with one init: the final layer
    norm's scale at random and EOS's row scaled by eos_scale (shrunk, so
    that greedy decoding writes tokens)."""
    if kind == "cif":
        jmodel = jcif.CIFModel(jcif.CIFConfig(**SMALL))
        tmodel = tcif.CIFModel(tcif.CIFConfig(**SMALL), device="cpu")
    else:
        kw = MMA_KINDS[kind]
        jmodel = jmma.MMAModel(jmma.MMAConfig(**SMALL, **kw))
        tmodel = tmma.MMAModel(tmma.MMAConfig(**SMALL, **kw), device="cpu")
    jp = jmodel.init(jax.random.PRNGKey(seed))
    dec = jp["decoder"]
    dec["embed_tokens"]["weight"] = dec["embed_tokens"]["weight"].at[
        EOS].multiply(eos_scale)
    dec["layer_norm"]["scale"] = jnp.asarray(np.random.RandomState(3).randn(
        16).astype(np.float32) * 3.0)
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                  jp)))
    return jmodel, jp, tmodel.eval()


def _agents(kind, acfg=None, seed=0, eos_scale=0.1):
    """(JAX fused agent, port fused agent) on one init."""
    jmodel, jp, tmodel = _pair(kind, seed, eos_scale)
    acfg = acfg or dict(max_src_frames=64, max_tgt_len=24)
    if kind == "cif":
        return (jagents.CIFAgent(jmodel, jp, JVocabulary(SYMBOLS),
                                 jagents.AgentConfig(**acfg), fused=True),
                tagents.CIFAgent(tmodel, Vocabulary(SYMBOLS),
                                 tagents.AgentConfig(**acfg), fused=True))
    return (jagents.MMAAgent(jmodel, jp, JVocabulary(SYMBOLS),
                             jagents.AgentConfig(**acfg), fused=True),
            tagents.MMAAgent(tmodel, Vocabulary(SYMBOLS),
                             tagents.AgentConfig(**acfg), fused=True))


# ---------------------------------------------------------------------------
# encoder_step with feat_valid
# ---------------------------------------------------------------------------

# feature frames per chunk: (seg + rc) x 4 first, then seg x 4; the final
# chunk's valid frames per example (0: no new frame at all)
PLAN = [24, 16, 16]
FINAL = [13, 0, 16, 5]


def test_encoder_step_feat_valid_matches_jax_and_b1():
    """Four utterances lock-step through the chunk plan, the final chunk
    zero-padded to 16 frames with feat_valid [13, 0, 16, 5]: every chunk's
    encoder output and lengths equal JAX's encoder_step with the same
    feat_valid, and each example's outputs on its valid frames equal its
    own B = 1 stream on its unpadded frames (its final chunk of 13, 0, 16
    and 5 frames)."""
    jmodel, jp, tmodel = _pair("cif")
    cfg = tmodel.cfg
    rng = np.random.RandomState(4)
    b, t = len(FINAL), sum(PLAN) + max(FINAL)
    feats = rng.randn(b, t, 80).astype(np.float32)
    for i, n in enumerate(FINAL):
        feats[i, sum(PLAN) + n:] = 0.0
    valid = np.array(FINAL)

    jstate = js2t.encoder_init_state(jp["encoder"], jmodel.cfg, b)
    tstate = ts2t.encoder_init_state(tmodel.encoder, cfg, b)
    batched, lengths, t0 = [], None, 0
    for k, c in enumerate(PLAN + [max(FINAL)]):
        finish = k == len(PLAN)
        chunk = feats[:, t0:t0 + c]
        t0 += c
        fv = valid if finish else None
        jout, jstate = js2t.encoder_step(
            jp["encoder"], jmodel.cfg, jstate, jnp.asarray(chunk), finish,
            feat_valid=None if fv is None else jnp.asarray(fv))
        with torch.no_grad():
            tout, tstate = ts2t.encoder_step(
                tmodel.encoder, cfg, tstate, torch.from_numpy(chunk), finish,
                feat_valid=None if fv is None else torch.from_numpy(fv))
        lengths = tout.lengths.numpy()
        np.testing.assert_array_equal(lengths, np.asarray(jout.lengths))
        for i, n in enumerate(lengths):
            np.testing.assert_allclose(tout.encoder_out[i, :n].numpy(),
                                       np.asarray(jout.encoder_out)[i, :n],
                                       **TOL)
        batched.append(tout.encoder_out)
    assert len(set(lengths.tolist())) == 3, lengths    # ragged flush

    for i, n in enumerate(FINAL):
        state = ts2t.encoder_init_state(tmodel.encoder, cfg, 1)
        outs, t0 = [], 0
        with torch.no_grad():
            for k, c in enumerate(PLAN + [n]):
                finish = k == len(PLAN)
                chunk = torch.from_numpy(feats[i:i + 1, t0:t0 + c])
                t0 += c
                out, state = ts2t.encoder_step(tmodel.encoder, cfg, state,
                                               chunk if c else None, finish)
                outs.append(out.encoder_out)
        alone = torch.cat(outs, 1)[0]
        mine = torch.cat([o[i] for o in batched[:-1]]
                         + [batched[-1][i, :lengths[i]]])
        assert mine.shape == alone.shape
        np.testing.assert_allclose(mine.numpy(), alone.numpy(), **TOL)


# ---------------------------------------------------------------------------
# cif_layer_step with x_valid
# ---------------------------------------------------------------------------

CIF_SMALL = dict(SMALL, embed_dim=64, input_feat=8)


def _cif_tol(xs, alpha_sum, beta):
    ulp = float(np.spacing(np.float32(alpha_sum)))
    return dict(rtol=1e-5, atol=1e-5 + 4 * ulp * np.abs(xs).max())


@pytest.mark.parametrize("beta", [1.0, 0.8])
def test_cif_layer_step_x_valid_matches_jax_and_b1(beta):
    """Three examples through chunks of 7 and 6 encoder frames, then a
    final chunk of 5 with x_valid [5, 2, 0]: fired features and counts
    equal JAX's cif_layer_step's with the same x_valid, and each example's
    equal its own B = 1 steps on its unpadded frames."""
    cfg_kw = dict(CIF_SMALL, cif_beta=beta)
    jcfg = jcif.CIFConfig(**cfg_kw)
    jp = jcif.cif_layer_init(jax.random.PRNGKey(0), jcfg)
    cfg = tcif.CIFConfig(**cfg_kw)
    layer = tcif.CIFLayer(cfg)
    layer.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    plan, valid = [7, 6, 5], np.array([5, 2, 0])
    x = np.random.RandomState(7).randn(3, sum(plan), 64).astype(np.float32)

    def run(xb, chunks, x_valid, batch):
        jstate = jcif.cif_layer_init_state(jp, jcfg, batch)
        state = tcif.cif_layer_init_state(layer, cfg, batch)
        fired_all, t0, running = [], 0, np.zeros(batch)
        for k, c in enumerate(chunks):
            finish = k == len(chunks) - 1
            xc = xb[:, t0:t0 + c]
            t0 += c
            xv = x_valid if finish else None
            with torch.no_grad():
                alpha, _ = tcif._alpha_from_x(layer, cfg, torch.from_numpy(xc),
                                              conv_cache=state.conv)
                keep = np.arange(c)[None, :] < (c if xv is None
                                                else xv[:, None])
                running += (alpha.numpy() * keep).sum(1)
                fired, n, state = tcif.cif_layer_step(
                    layer, cfg, state, torch.from_numpy(xc), finish,
                    x_valid=None if xv is None else torch.from_numpy(xv))
            r = running / beta
            assert (np.abs(r - np.round(r)) > 1e-3).all(), r
            fj, nj, jstate = jcif.cif_layer_step(
                jp, jcfg, jstate, jnp.asarray(xc), finish,
                x_valid=None if xv is None else jnp.asarray(xv))
            np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
            np.testing.assert_allclose(fired.numpy(), np.asarray(fj),
                                       **_cif_tol(xb, running.max(), beta))
            fired_all.append([fired[i, :int(n[i])] for i in range(batch)])
        return [torch.cat([f[i] for f in fired_all]) for i in range(batch)]

    batched = run(x, plan, valid, 3)
    for i, n in enumerate(valid):
        alone = run(x[i:i + 1, :sum(plan[:-1]) + n], plan[:-1] + [n],
                    np.array([n]), 1)[0]
        assert alone.shape == batched[i].shape
        np.testing.assert_allclose(batched[i].numpy(), alone.numpy(),
                                   **_cif_tol(x, 20.0, beta))


# ---------------------------------------------------------------------------
# fused steps with n_valid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["cif", "waitk"])
def test_fused_step_n_valid_matches_jax(kind):
    """Three utterances' fbank features lock-step through the fused step
    (24 frames, then 16 at a time), the final chunk with n_valid [16, 3,
    0]: n_new at every chunk, the tokens and n_tokens equal JAX's fused
    step's."""
    jmodel, jp, tmodel = _pair(kind)
    feats = np.random.RandomState(5).randn(3, 24 + 16 * 4, 80).astype(
        np.float32)
    plan = [(0, 24)] + [(t, t + 16) for t in range(24, 24 + 16 * 4, 16)]
    valid = np.array([16, 3, 0])
    if kind == "cif":
        jstep = jfused.make_cif_fused_step(jp, jmodel.cfg)
        jstate = jfused.cif_fused_init(jp, jmodel.cfg, 32, batch=3)
        step = tfused.make_cif_fused_step(tmodel, tmodel.cfg)
        state = tfused.cif_fused_init(tmodel, tmodel.cfg, 32, batch=3)
    else:
        jstep = jfused.make_mma_fused_step(jp, jmodel.cfg)
        jstate = jfused.mma_fused_init(jp, jmodel.cfg, 64, 32, batch=3)
        step = tfused.make_mma_fused_step(tmodel, tmodel.cfg)
        state = tfused.mma_fused_init(tmodel, tmodel.cfg, 64, 32, batch=3)
    for k, (a, b) in enumerate(plan):
        finish = k == len(plan) - 1
        chunk = feats[:, a:b].copy()
        if finish:
            for i, n in enumerate(valid):
                chunk[i, n:] = 0.0
        nv = valid if finish else None
        jstate, jn = jstep(jstate, jnp.asarray(chunk), finish=finish,
                           n_valid=None if nv is None else jnp.asarray(nv))
        state, n = step(state, torch.from_numpy(chunk), finish=finish,
                        n_valid=None if nv is None else torch.from_numpy(nv))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(state.n_tokens.numpy(),
                                  np.asarray(jstate.n_tokens))
    np.testing.assert_array_equal(state.tokens.numpy(),
                                  np.asarray(jstate.tokens))
    assert int(state.n_tokens.min()) > 1, state.n_tokens


# ---------------------------------------------------------------------------
# evaluate_batched
# ---------------------------------------------------------------------------

def _log(path):
    inst = sorted((json.loads(line) for line in open(path)),
                  key=lambda x: x["index"])
    return [(x["prediction"], x["delays"], x["truncated"], x["mode"])
            for x in inst]


def _same(got, want):
    for i, ((pg, dg, tg, _), (pw, dw, tw, _)) in enumerate(zip(got, want)):
        assert pg == pw, f"utt {i}: {pg!r} != {pw!r}"
        np.testing.assert_allclose(dg, dw, atol=1e-6, err_msg=f"utt {i}")
        assert tg == tw, i


def mma_gaps(monkeypatch):
    """Record the top-two logit gap of every MMA decoder call's WRITE rows
    (the tokens it would write)."""
    gaps, real = [], tmma.mma_decoder_step

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        top = out[0].float().topk(2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1])[out[1] == 1].tolist())
        return out

    monkeypatch.setattr(tmma, "mma_decoder_step", recorded)
    return gaps


def parting_mid_stream(log, wavs, bucket=(1, 2, 4)):
    """The words each utterance of the 3-utterance bucket wrote before its
    source ended, by delay: some, and not the same for all three."""
    mid = [tuple(d for d in log[i][1] if d < len(wavs[i]) / 16.0)
           for i in bucket]
    return any(mid) and len(set(mid)) > 1


# (model, agent config, seed) of each evaluate_batched case.  MMA's learned
# heads ("ilk", infinite lookback): seed 3, under which the examples write
# from the first chunks and part ways within a bucket.  "cif_full": room
# for 16 tokens, which four of the five utterances fill, the 1.3 s one at
# 1215 ms, before its source ends.
CASES = {"cif": ("cif", None, 0), "waitk": ("waitk", None, 0),
         "ilk": ("ilk", None, 3),
         "cif_full": ("cif", dict(max_src_frames=64, max_tgt_len=16), 0)}


def case_agents(kind):
    model, acfg, seed = CASES[kind]
    return _agents(model, acfg, seed=seed)


def _same_but_full_buffers(got, want):
    """`_same`, but for the last delay of each truncated utterance: JAX's
    batched evaluator gives the last word of a full token buffer the end of
    the bucket's source, where both B = 1 sessions and the port's batched
    one give it the delay of the chunk that filled the buffer."""
    for i, ((pg, dg, tg, _), (pw, dw, tw, _)) in enumerate(zip(got, want)):
        assert pg == pw and tg == tw, f"utt {i}: {pg!r} != {pw!r}"
        n = len(dg) - 1 if tg else len(dg)
        np.testing.assert_allclose(dg[:n], dw[:n], atol=1e-6,
                                   err_msg=f"utt {i}")


def filled_mid_stream(log, wavs):
    """Some utterance filled its token buffer before its source ended."""
    return any(x[2] and x[1] and x[1][-1] < len(w) / 16.0
               for x, w in zip(log, wavs))


def hold_against_b1_and_jax(kind, jagent, wavs, refs, paths, got, scan):
    """The batched run's log (paths[mode]) against the port's B = 1 log
    (paths["b1"]) and JAX's batched evaluator (paths["jax"]); with a full
    token buffer ("cif_full") against JAX's B = 1 evaluate, JAX's batched
    one differing only as `_same_but_full_buffers` says.  BLEU and the
    latencies equal JAX's."""
    mode = "scan" if scan else "stepwise"
    log = _log(paths[mode])
    _same(log, _log(paths["b1"]))
    want = jeval.evaluate_batched(jagent, wavs, refs, batch_size=3,
                                  log_path=paths["jax"], scan=scan)
    assert {x[3] for x in log} == {mode} and got["mode"] == mode
    if kind == "cif_full":
        _same_but_full_buffers(log, _log(paths["jax"]))
        want = jeval.evaluate(jagent, wavs, refs, log_path=paths["jax_b1"])
        _same(log, _log(paths["jax_b1"]))
        assert filled_mid_stream(log, wavs), log
        assert not all(x[2] for x in log), log
    else:
        _same(log, _log(paths["jax"]))
        assert set(got) == set(want)
    if kind == "ilk":
        assert parting_mid_stream(log, wavs), log
    for key in ("BLEU", "AL", "AP", "DAL"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    return log


@pytest.mark.parametrize("kind", ["cif", "waitk", "ilk", "cif_full"])
def test_evaluate_batched_matches_b1_and_jax(kind, tmp_path, monkeypatch):
    """evaluate_batched at batch_size 3 over 0.5 / 0.9 / 1.0 / 1.3 / 1.0 s
    (buckets of 1, 3 and 1 utterances): each utterance's words, delays and
    truncated flag equal the port's B = 1 evaluate (fused) and JAX's
    evaluate_batched on the same weights; BLEU and the latencies equal
    JAX's.  MMA's learned heads ("ilk"): the bucket's examples write
    mid-stream and part ways, and every token the B = 1 run writes leads
    its runner-up by more than 1e-4 (no argmax tie).  A full token buffer
    ("cif_full"): as `hold_against_b1_and_jax` says."""
    jagent, agent = case_agents(kind)
    wavs = _audios()
    refs = ["the cats sat", "a dog ran far", "home", "big cats", "and back"]
    paths = {k: str(tmp_path / f"{k}.log")
             for k in ("b1", "stepwise", "jax", "jax_b1")}
    gaps = mma_gaps(monkeypatch) if kind == "ilk" else [1.0]
    teval.evaluate(agent, wavs, refs, log_path=paths["b1"])
    assert min(gaps) > 1e-4
    got = teval.evaluate_batched(agent, wavs, refs, batch_size=3,
                                 log_path=paths["stepwise"])
    b3 = hold_against_b1_and_jax(kind, jagent, wavs, refs, paths, got,
                                 scan=False)
    assert sum(len(x[0].split()) for x in b3) > 5, b3
