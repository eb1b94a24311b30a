"""Streaming the Transformer-Transducer of simulst_tpu_torch on the CPU:
the fused step (`make_transducer_fused_step`) vs the step-wise
`TransducerSession` vs the JAX package's `TransducerAgent`, the batched
evaluator (`evaluate_batched`, B = 3, lock-step within chunk-count
buckets, step-wise and scanned) vs B = 1, the buffer caps' `truncated`
flags, and exp/6_transducer.sh's three commands (cli/train, cli/generate
--model transducer --beam 1, cli/stream_eval --agent transducer) on a
synthetic manifest with --device cpu.

Small models as tests/test_batched_stream.py's transducer case (width 16,
one encoder and one label-encoder layer, vocab 24; downsample 1 and 2,
each with seed 8), JAX init bridged to the port, the
blank's embedding row scaled 2x and EOS's 2.2x, so that the greedy
transducer writes in the first chunks, READs (all blank, or a rejected
early EOS) and ends on EOS or a full buffer; the audio is tones under a
1.5 Hz on / off envelope, 0.5 / 0.9 / 1.0 / 1.3 / 1.0 s, with global CMVN
from its own fbank.  fp32 with jax_default_matmul_precision float32
(tests/conftest.py).
Tolerances: tokens, words, truncated flags exactly; delays atol 1e-6.
Every comparison also holds the B = 1 session's deciding logits to a
top-two gap above 1e-4 (`_gaps`), so no token is an argmax tie.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

from simulst_tpu.data.vocab import Vocabulary as JVocabulary  # noqa: E402
from simulst_tpu.models import transducer as jtr  # noqa: E402
from simulst_tpu.stream import agents as jagents  # noqa: E402
from simulst_tpu.stream import evaluator as jeval  # noqa: E402
from simulst_tpu_torch.cli import generate as tgen  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data.vocab import SPECIALS, Vocabulary  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.models import transducer as ttr  # noqa: E402
from simulst_tpu_torch.ops import fbank as tfbank  # noqa: E402
from simulst_tpu_torch.stream import agents as tagents  # noqa: E402
from simulst_tpu_torch.stream import evaluator as teval  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from test_torch_port_stream_eval import (CLI_SMALL, _stream_eval,  # noqa: E402,E501
                                         _train, _write_data)

SYMBOLS = list(SPECIALS) + [f"▁w{i}" for i in range(16)] + \
    [f"x{i}" for i in range(4)]
SMALL = dict(vocab_size=24, input_feat=80, conv_channels=16, embed_dim=16,
             ffn_dim=32, encoder_layers=1, encoder_heads=2, decoder_layers=1,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2, ctc_layer=False,
             dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
CASES = [(1, 8), (2, 8)]          # (downsample, seed)
SECONDS = [0.5, 0.9, 1.0, 1.3, 1.0]
EOS = 2
TIE_GAP = 1e-4


def _audios():
    """Tones under a 1.5 Hz on / off envelope over a little noise."""
    out = []
    for i, s in enumerate(SECONDS):
        rng = np.random.RandomState(40 + i)
        t = np.arange(int(16000 * s)) / 16000.0
        env = (np.sin(2 * np.pi * 1.5 * t + rng.uniform(0, 6)) > 0)
        tone = np.sin(2 * np.pi * rng.uniform(200, 900) * t)
        out.append((0.3 * env * tone + 0.01 * rng.randn(len(t))).astype(
            np.float32))
    return out


def _cmvn():
    feats = np.concatenate([tfbank.fbank_batch(torch.from_numpy(
        w[None] * 32768.0))[0].numpy() for w in _audios()])
    return feats.mean(0), feats.std(0)


def _agents(downsample, seed, acfg=None, fused=True):
    """(JAX step-wise agent, port agent) on one init, the blank's row x 2
    and EOS's x 2.2."""
    cfg = dict(SMALL, downsample=downsample)
    jmodel = jtr.TransducerModel(jtr.TransducerConfig(**cfg))
    jp = jmodel.init(jax.random.PRNGKey(seed))
    emb = jp["decoder"]["embed_tokens"]
    emb["weight"] = emb["weight"].at[0].multiply(2.0).at[EOS].multiply(2.2)
    tmodel = ttr.TransducerModel(ttr.TransducerConfig(**cfg), device="cpu")
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                  jp)))
    acfg = acfg or dict(max_src_frames=256, max_tgt_len=24)
    cmvn = _cmvn()
    return (jagents.TransducerAgent(jmodel, jp, JVocabulary(SYMBOLS),
                                    jagents.AgentConfig(**acfg),
                                    global_cmvn=cmvn),
            tagents.TransducerAgent(tmodel.eval(), Vocabulary(SYMBOLS),
                                    tagents.AgentConfig(**acfg),
                                    global_cmvn=cmvn, fused=fused))


def _gaps(monkeypatch):
    """Record the top-two gap of every logits row that decode_step
    returns for an emitting example (the token it would write)."""
    gaps, real = [], ttr.decode_step

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        top = out[0].float().topk(2, dim=-1).values
        gaps.extend((top[:, 0] - top[:, 1])[out[1]].tolist())
        return out

    monkeypatch.setattr(ttr, "decode_step", recorded)
    return gaps


@pytest.mark.parametrize("downsample,seed", CASES)
def test_fused_and_stepwise_sessions_match_jax(downsample, seed,
                                               monkeypatch):
    """Per utterance: the fused session's words, delays and truncated
    flag equal the step-wise session's and JAX's step-wise agent's; the
    traffic writes in more than one chunk before the source ends, READs
    between, and ends some utterances on EOS before the buffer fills."""
    jagent, fused = _agents(downsample, seed)
    _, stepwise = _agents(downsample, seed, fused=False)
    wavs = _audios()
    gaps = _gaps(monkeypatch)
    got = [teval.run_session(fused, w) for w in wavs]
    assert min(gaps) > TIE_GAP
    for w, g in zip(wavs, got):
        s = teval.run_session(stepwise, w)
        j = jeval.run_session(jagent, w)
        for want in (s, j):
            assert g[0] == want[0]
            np.testing.assert_allclose(g[1], want[1], atol=1e-6)
            assert g[3] == want[3]
    # writes in two chunks before the source ends (READs between them),
    # and utterances that end on EOS before their token buffer fills
    lengths_ms = [len(w) / 16.0 for w in wavs]
    assert any(len({d for d in ds if d < ms}) > 1
               for (_, ds, _, _), ms in zip(got, lengths_ms)), got
    assert not all(t for *_, t in got), got


@pytest.mark.parametrize("downsample,seed", CASES)
def test_evaluate_batched_matches_b1(downsample, seed, tmp_path,
                                     monkeypatch):
    """evaluate_batched at batch_size 3 (buckets of 1, 3 and 1 utterances,
    final chunks of other sizes), step-wise and scanned: every
    utterance's words, delays and truncated flag equal its fused B = 1
    session's (which test_fused_and_stepwise_sessions_match_jax holds to
    JAX's)."""
    _, agent = _agents(downsample, seed)
    wavs = _audios()
    gaps = _gaps(monkeypatch)
    teval.evaluate(agent, wavs, log_path=str(tmp_path / "b1.log"))
    assert min(gaps) > TIE_GAP
    want = _log(tmp_path / "b1.log")
    for scan in (False, True):
        path = tmp_path / f"b3_{scan}.log"
        scores = teval.evaluate_batched(agent, wavs, batch_size=3,
                                        log_path=str(path), scan=scan)
        assert scores["mode"] == ("scan" if scan else "stepwise")
        got = _log(path)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g[0] == w[0] and g[2] == w[2], (i, g, w)
            np.testing.assert_allclose(g[1], w[1], atol=1e-6)
    assert sum(len(x[0].split()) for x in want) > 5, want


def _log(path):
    inst = sorted((json.loads(line) for line in open(path)),
                  key=lambda x: x["index"])
    return [(x["prediction"], x["delays"], x["truncated"]) for x in inst]


def test_buffer_caps_set_truncated(tmp_path):
    """Room for 16 encoder frames and 12 tokens: the longer utterances
    overflow; each example's flag and words, step-wise B = 1, fused B = 1
    and batched B = 3, equal JAX's step-wise agent's."""
    acfg = dict(max_src_frames=16, max_tgt_len=12)
    jagent, fused = _agents(*CASES[0], acfg)
    _, stepwise = _agents(*CASES[0], acfg, fused=False)
    wavs = _audios()
    want = [jeval.run_session(jagent, w) for w in wavs]
    flags = [x[3] for x in want]
    assert any(flags) and not all(flags), flags
    for agent in (fused, stepwise):
        got = [teval.run_session(agent, w) for w in wavs]
        assert [(g[0], g[3]) for g in got] == [(w[0], w[3]) for w in want]
    teval.evaluate_batched(fused, wavs, batch_size=3,
                           log_path=str(tmp_path / "b3.log"))
    assert [(x[0].split(), x[2]) for x in _log(tmp_path / "b3.log")] == \
        [(w[0], w[3]) for w in want]


# ---------------------------------------------------------------------------
# exp/6_transducer.sh on the CPU
# ---------------------------------------------------------------------------

def test_exp6_commands_on_the_cpu(tmp_path):
    """exp/6_transducer.sh's three commands on a MuST-C-shaped manifest
    with --device cpu: cli/train (--task st --model transducer --loss rnnt,
    FastEmit 0.01, offline factor 1, the encoder from an ASR checkpoint
    with a CTC head), cli/generate --model transducer --beam 1 on the dev
    split (and beam 2: the D- lines of every utterance and a SCORE line),
    cli/stream_eval --agent transducer, fused and step-wise with the same
    predictions and delays, and with --fused --batch-size 2."""
    _write_data(tmp_path)
    asr = ts2t.S2TEmformerModel(
        ts2t.S2TEmformerConfig(vocab_size=14, ctc_layer=True, **CLI_SMALL),
        device="cpu", generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path / "asr"), asr.state_dict(),
                          {"model": "s2t_emformer"})
    ckpt = _train(tmp_path, "transducer", [
        "--task", "st", "--model", "transducer", "--loss", "rnnt",
        "--loss-override", "fastemit_lambda=0.01",
        "--loss-override", "offline_factor=1.0"])
    state, meta = tckpt.load_checkpoint(str(ckpt))
    assert meta["model"] == "transducer" and meta["cmvn"] == "global"
    assert "encoder.ctc_layer.weight" not in state

    for beam in ("1", "2"):
        out = tmp_path / f"gen_dev_{beam}.txt"
        score = tgen.main(["--data", str(tmp_path), "--gen-subset", "dev",
                           "--task", "st", "--checkpoint", str(ckpt),
                           "--model", "transducer", "--beam", beam,
                           "--max-len", "12", "--output", str(out),
                           "--device", "cpu"])
        lines = out.read_text().splitlines()
        assert sum(x.startswith("D-") for x in lines) == 4
        assert lines[-1].startswith("SCORE\tbleu\t") and np.isfinite(score)

    # 48 tokens: under the fused step's 64 attempts per chunk, so that the
    # fused and the step-wise sessions write the same tokens per chunk
    cap = ["--agent", "transducer", "--max-tgt-len", "48"]
    fused = _stream_eval(tmp_path, ckpt, "fused", *cap, "--fused")
    assert fused == _stream_eval(tmp_path, ckpt, "stepwise", *cap)
    assert _stream_eval(tmp_path, ckpt, "b2", *cap, "--fused",
                        "--batch-size", "2") == fused
