"""The streaming evaluation runtime of simulst_tpu_torch, on the CPU:
`OnlineFbank` against the JAX package's and against the offline fbank;
BLEU, WER and the AL / AP / DAL latencies, and the evaluator's word and
delay bookkeeping (step-wise and fused) against the JAX evaluator on one
scripted token schedule; the fused CIF and MMA sessions against their
step-wise sessions; and the CLI end to end: cli/train --model cif from an
ASR checkpoint as exp/3_cif.sh, then cli/stream_eval --agent cif and
--agent mma, fused and step-wise, on written wavs.

Small models: width 16, 1 encoder and 2 decoder layers, 2 heads, FFN 32,
vocab 24, 80 fbank features, segment 4 / left context 8 / right context 2
frames after subsampling; the final layer norm's scale drawn at random
(N(0, 9)) and EOS's embedding row shrunk so that greedy decoding writes
more than EOS.  Tolerances: OnlineFbank vs JAX's rtol 2e-5, atol 2e-4
on log-mel features of magnitude up to 40 (both fp32; numpy's FFT and
torch's round differently), chunked vs offline within the port atol
1e-5; BLEU and the latencies rtol 1e-12 (the same float64 arithmetic);
words, delays and tokens exactly.
"""
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

from simulst_tpu.decode import scoring as jscoring  # noqa: E402
from simulst_tpu.ops import fbank as jfbank  # noqa: E402
from simulst_tpu.stream import evaluator as jeval  # noqa: E402
from simulst_tpu_torch.cli import stream_eval as tstream_cli  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.data.vocab import SPECIALS, Vocabulary  # noqa: E402
from simulst_tpu_torch.decode import scoring as tscoring  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.ops import fbank as tfbank  # noqa: E402
from simulst_tpu_torch.stream import agents as tagents  # noqa: E402
from simulst_tpu_torch.stream import evaluator as teval  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402

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


def _wave(seed, n):
    """Seeded tones and noise in [-1, 1]."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    wav = sum(a * np.sin(2 * np.pi * f * t) for a, f in
              zip(rng.uniform(0.05, 0.3, 3), rng.uniform(100, 3000, 3)))
    return np.clip(wav + 0.05 * rng.randn(n), -1, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# OnlineFbank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pcm", ["float", "int16", "float+gcmvn"])
def test_online_fbank_matches_jax_and_offline(pcm):
    wav = _wave(0, 21000)
    gcmvn = None
    if pcm == "int16":
        wav = np.round(wav * 32767).astype(np.int16)
    elif pcm == "float+gcmvn":
        rng = np.random.RandomState(1)
        gcmvn = (rng.randn(80).astype(np.float32),
                 rng.uniform(0.5, 2.0, 80).astype(np.float32))
    ours = tfbank.OnlineFbank(global_cmvn=gcmvn)
    theirs = jfbank.OnlineFbank(global_cmvn=gcmvn)
    got, t0 = [], 0
    for n in (4080, 2560, 2560, 1000, 37, 0, 10763):
        chunk = wav[t0:t0 + n]
        t0 += n
        a, b = ours(chunk), theirs(chunk)
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-4)
        got.append(a)
    got = np.concatenate(got)
    full = wav.astype(np.float32) / (2 ** 15 if pcm == "int16" else 1.0)
    offline = tfbank.fbank_batch(torch.from_numpy(full * 2 ** 15)[None])[0]
    if gcmvn is not None:
        offline = (offline - torch.from_numpy(gcmvn[0])) / torch.from_numpy(
            gcmvn[1])
    assert got.shape == (tfbank.num_frames(len(wav)), 80)
    np.testing.assert_allclose(got, offline.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# scoring and the evaluator's bookkeeping
# ---------------------------------------------------------------------------

def _sentences(rng, n):
    words = "the a cat dog sat ran on far away home big and back".split()
    return [" ".join(rng.choice(words, rng.randint(1, 12))) for _ in range(n)]


def test_bleu_and_wer_match_jax():
    """Lowercase words without punctuation, where sacrebleu's 13a tokenizer
    (which the JAX package calls when present) splits as whitespace does."""
    rng = np.random.RandomState(2)
    refs, hyps = _sentences(rng, 20), _sentences(rng, 20)
    hyps[:5] = refs[:5]
    for r, h in ((refs, hyps), (refs[:1], hyps[:1]), (refs[:3], refs[:3])):
        np.testing.assert_allclose(tscoring.corpus_bleu(r, h),
                                   jscoring.corpus_bleu(r, h), rtol=1e-12)
        np.testing.assert_allclose(
            tscoring.corpus_bleu(r, h),
            jscoring.bleu_from_stats(*jscoring.bleu_stats(r, h)), rtol=1e-12)
        assert tscoring.wer(r, h) == jscoring.wer(r, h)


@pytest.mark.parametrize("kind", ["AL", "AP", "DAL"])
def test_latency_matches_jax(kind):
    rng = np.random.RandomState(3)
    for n in (1, 5, 17):
        delays = np.sort(rng.uniform(0, 3000, n)).tolist()
        for src_ms in (1500.0, 3000.0):
            np.testing.assert_allclose(
                teval._latency(delays, src_ms, n, kind),
                jeval._latency(delays, src_ms, n, kind), rtol=1e-12)
    assert teval._latency([], 1000.0, 0, kind) == 0.0


# a schedule per utterance: the tokens each chunk writes (fused), or the
# step-wise actions: "R" a READ, an int a WRITE, None a rejected EOS
SCHEDULES = [
    [[], [4, 5], [6], [], [7, 8, 9, 10], [11, EOS]],
    [[12], [], [13, 14, 15], [16, 17, 18, 19, 20, 21, 22, 23]],
    [[], [], []],
]


def _actions(chunks):
    out = []
    for toks in chunks:
        out.append("R")
        out += toks
        if toks and toks[-1] == EOS:
            return out
        out.append(None)            # a premature EOS, then the next READ
    return out


class _FusedSession:
    def __init__(self, chunks):
        self.chunks = list(chunks)
        self.next_chunk_ms = 255
        self.finished = False
        self.truncated = False

    def process_chunk(self, samples, finished):
        toks = self.chunks.pop(0) if self.chunks else []
        self.next_chunk_ms = 160
        self.finished = EOS in toks
        return toks


class _StepSession:
    def __init__(self, chunks):
        self.actions = _actions(chunks)
        self.next_chunk_ms = 255
        self.finished = False
        self.finished_read = False
        self.truncated = False

    def policy(self):
        if not self.actions:
            return 0
        return 0 if self.actions[0] == "R" else 1

    def push_audio(self, samples, finished):
        if self.actions and self.actions[0] == "R":
            self.actions.pop(0)
        self.next_chunk_ms = 160
        self.finished_read = self.finished_read or finished

    def predict(self):
        tok = self.actions.pop(0)
        self.finished = tok == EOS
        return tok


class _ScriptedAgent:
    def __init__(self, session_cls, schedules):
        self.vocab = types.SimpleNamespace(symbols=SYMBOLS)
        self.session_cls = session_cls
        self.schedules = list(schedules)

    def new_session(self):
        return self.session_cls(self.schedules.pop(0))


@pytest.mark.parametrize("session_cls", [_FusedSession, _StepSession],
                         ids=["fused", "stepwise"])
def test_evaluator_bookkeeping_matches_jax(session_cls, tmp_path):
    """evaluate() over three utterances (1.2, 0.9 and 0.5 s) driven by one
    token schedule through the port's and the JAX package's evaluators:
    words, delays, source lengths, BLEU, AL, AP and DAL equal (the _CA
    metrics are wall-clock times and differ from run to run)."""
    wavs = [np.zeros(n, np.float32) for n in (19200, 14400, 8000)]
    refs = ["the cats sat on a mat", "dog running far", "home"]
    got = teval.evaluate(_ScriptedAgent(session_cls, SCHEDULES), wavs, refs,
                         log_path=str(tmp_path / "port.log"))
    want = jeval.evaluate(_ScriptedAgent(session_cls, SCHEDULES), wavs, refs,
                          log_path=str(tmp_path / "jax.log"))
    assert set(got) == set(want)
    for key in ("BLEU", "AL", "AP", "DAL"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert got["mode"] == want["mode"] and got["truncated"] == 0
    for a, b in zip((tmp_path / "port.log").read_text().splitlines(),
                    (tmp_path / "jax.log").read_text().splitlines()):
        a, b = json.loads(a), json.loads(b)
        for key in ("prediction", "reference", "delays", "source_length_ms",
                    "truncated"):
            assert a[key] == b[key], key
    assert json.loads((tmp_path / "port.log").read_text().splitlines()[0])[
        "prediction"] == "the cats sat on amat"


# ---------------------------------------------------------------------------
# fused sessions vs step-wise sessions
# ---------------------------------------------------------------------------

def _writing(model, cfg):
    """The final layer norm's scale at random and EOS's row shrunk, so that
    greedy decoding writes tokens."""
    with torch.no_grad():
        model.decoder.layer_norm.scale.copy_(torch.from_numpy(
            np.random.RandomState(3).randn(cfg.embed_dim).astype(np.float32)
            * 3.0))
        model.decoder.embed_tokens.weight[EOS] *= 0.1
    return model.eval()


AGENTS = [("cif", {}), ("cif", dict(cif_infinite_lookback=True,
                                    cif_highway=True)),
          ("cif beta 0.8", {}),
          ("mma", dict(simul_attn_type="waitk_fixed_pre_decision",
                       fixed_pre_decision_ratio=2, waitk_lagging=2)),
          ("mma", dict(simul_attn_type="infinite_lookback_fixed_pre_decision",
                       fixed_pre_decision_ratio=2))]


@pytest.mark.parametrize("kind,model_kw", AGENTS,
                         ids=["cif", "cif lookback+highway", "cif beta 0.8",
                              "waitk", "mma lookback"])
def test_fused_session_equals_stepwise_session(kind, model_kw):
    """Two utterances (1.6 s float, 2.2 s int16) through evaluate(): the
    fused agent (make_cif_fused_step / make_mma_fused_step, one call per
    chunk) writes the words of the step-wise session at the same delays."""
    vocab = Vocabulary(SYMBOLS)
    gen = torch.Generator().manual_seed(0)
    if kind.startswith("cif"):
        cfg = tcif.CIFConfig(**SMALL, **model_kw)
        model = _writing(tcif.CIFModel(cfg, generator=gen, device="cpu"), cfg)
        beta = 0.8 if kind.endswith("0.8") else None

        def make(fused):
            return tagents.CIFAgent(model, vocab, tagents.AgentConfig(
                max_src_frames=64, max_tgt_len=48), cif_beta=beta,
                fused=fused)
    else:
        cfg = tmma.MMAConfig(**SMALL, **model_kw)
        model = _writing(tmma.MMAModel(cfg, generator=gen, device="cpu"), cfg)

        def make(fused):
            return tagents.MMAAgent(model, vocab, tagents.AgentConfig(
                max_src_frames=64, max_tgt_len=48), fused=fused)
    wavs = [_wave(4, 25600),
            np.round(_wave(5, 35200) * 32767).astype(np.int16)]
    outs = []
    for fused in (True, False):
        agent = make(fused)
        outs.append([teval.run_session(agent, w)[:2] for w in wavs])
    assert outs[0] == outs[1]
    assert sum(len(words) for words, _ in outs[0]) > 2, outs[0]


# ---------------------------------------------------------------------------
# the CLI: exp/3_cif.sh's training, then cli/stream_eval
# ---------------------------------------------------------------------------

CLI_SMALL = {k: v for k, v in SMALL.items() if k != "vocab_size"}


def _write_data(tmp_path):
    """A MuST-C-shaped manifest of zero features (80 wide), global CMVN
    stats, a dictionary of 10 pieces, and two wavs with their
    references."""
    rows = tsyn.mustc_like_rows(16, seed=4, tmpdir=str(tmp_path),
                                feat_dim=80)
    for r in rows:   # 1-4 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))
    np.savez(tmp_path / "gcmvn.npz", mean=np.zeros(80, np.float32),
             std=np.full(80, 4.0, np.float32))
    from scipy.io import wavfile
    paths = []
    for i, n in enumerate((24000, 30400)):
        path = tmp_path / f"utt{i}.wav"
        wavfile.write(str(path), 16000,
                      np.round(_wave(10 + i, n) * 32767).astype(np.int16))
        paths.append(str(path))
    (tmp_path / "dev.wav_list").write_text("\n".join(paths) + "\n")
    (tmp_path / "dev.de").write_text("aaa bbb ccc\nddd eee\n")


def _train(tmp_path, name, args):
    save = tmp_path / name
    state = tcli.main(args + [
        "--data", str(tmp_path), "--device", "cpu", "--cmvn", "global",
        "--max-updates", "2", "--max-tokens", "1600", "--save-dir",
        str(save), "--load-pretrained-encoder-from", str(tmp_path / "asr"),
        "--lr", "5e-4", "--warmup-updates", "4000", "--clip-norm", "10",
        *[f"--override={k}={v}" for k, v in CLI_SMALL.items()]])
    assert state.step == 2
    return save / "checkpoint_last"


def _stream_eval(tmp_path, ckpt, name, *extra):
    out = tmp_path / "simul" / name
    scores = tstream_cli.main([
        "--source", str(tmp_path / "dev.wav_list"),
        "--target", str(tmp_path / "dev.de"), "--checkpoint", str(ckpt),
        "--vocab", str(tmp_path / "spm_unigram.txt"),
        "--global-cmvn", str(tmp_path / "gcmvn.npz"), "--device", "cpu",
        "--max-tgt-len", "100", "--output", str(out), *extra])
    assert json.loads((out / "scores").read_text()) == scores
    assert {"BLEU", "AL", "AP", "DAL", "AL_CA"} <= set(scores)
    log = [json.loads(line) for line in
           (out / "instances.log").read_text().splitlines()]
    assert len(log) == 2 and scores["truncated"] == sum(
        x["truncated"] for x in log)
    return [(x["prediction"], x["delays"], x["truncated"]) for x in log]


def test_cli_trains_cif_and_stream_evaluates_cif_and_mma(tmp_path):
    """exp/3_cif.sh's options (cif_beta 1, the CTC head, CTC factor 0.3,
    quantity factor 1 with the alignment targets) from an ASR checkpoint
    with a CTC head, two updates; an MMA student the same way; then
    cli/stream_eval --agent cif and --agent mma, each fused and step-wise
    with the same predictions and delays, writing `scores` and
    `instances.log`; then CIF with --batch-size 2 and with
    --scan-sessions, each with the fused B = 1 predictions and delays."""
    _write_data(tmp_path)
    asr = ts2t.S2TEmformerModel(
        ts2t.S2TEmformerConfig(vocab_size=14, ctc_layer=True, **CLI_SMALL),
        device="cpu", generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(tmp_path / "asr"), asr.state_dict(),
                          {"model": "s2t_emformer"})
    cif = _train(tmp_path, "cif", [
        "--task", "st", "--model", "cif", "--loss", "cif",
        "--override", "cif_beta=1.0", "--override", "ctc_layer=true",
        "--loss-override", "ctc_factor=0.3",
        "--loss-override", "quant_factor=1.0",
        "--loss-override", "quant_type=align"])
    state, meta = tckpt.load_checkpoint(str(cif))
    assert meta["model"] == "cif" and meta["cmvn"] == "global"
    assert "encoder.ctc_layer.weight" in state and "cif.proj.weight" in state
    mma = _train(tmp_path, "mma", [
        "--task", "st", "--model", "mma", "--loss", "mma",
        "--override", "simul_attn_type=waitk_fixed_pre_decision",
        "--override", "fixed_pre_decision_ratio=2",
        "--override", "waitk_lagging=2"])

    fused_cif = _stream_eval(tmp_path, cif, "cif", "--agent", "cif",
                             "--fused", "--cif-beta", "1.0")
    assert fused_cif == _stream_eval(tmp_path, cif, "cif_stepwise",
                                     "--agent", "cif")
    fused = _stream_eval(tmp_path, mma, "mma", "--agent", "mma", "--fused")
    assert fused == _stream_eval(tmp_path, mma, "mma_stepwise", "--agent",
                                 "waitk", "--waitk", "2")
    for extra in (["--batch-size", "2"], ["--scan-sessions"]):
        assert _stream_eval(tmp_path, cif, extra[0][2:], "--agent", "cif",
                            "--fused", *extra) == fused_cif
