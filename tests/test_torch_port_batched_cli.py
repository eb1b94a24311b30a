"""The batched streaming CLIs of simulst_tpu_torch against the JAX
package's, on the CPU: cli/stream_eval --fused --batch-size 3, with
--scan-sessions and with --scan-sessions --no-ca-pass, on written int16
wavs from a tiny CIF checkpoint trained by the port's cli/train (two
updates, as exp/3_cif.sh from an ASR encoder), against the JAX CLI on the
same weights (its checkpoint loader stood in by the port checkpoint's
parameters in the JAX tree); --profile DIR; cli/latency_bleu over the
result directories; and the SimulEval adapter
(stream/simuleval_agent.py) driven by a mock SimulEval event loop, as
tests/test_simuleval_agent.py drives the JAX one.

Small models: width 16, 1 encoder and 2 decoder layers (2 + 2 for the
SimulEval models), 2 heads, FFN 32, 80 fbank features, segment 4 / left
context 8 / right context 2 frames after subsampling.  Tolerances: words,
delays, flags, mode stamps and the latency table exactly; BLEU and the
latencies rtol 1e-12 (the same float64 arithmetic on the same delays).
"""
import json
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

from simulst_tpu.cli import latency_bleu as jlb  # noqa: E402
from simulst_tpu.cli import stream_eval as jstream_cli  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.stream import build as jbuild  # noqa: E402
from simulst_tpu_torch import config as cfglib  # noqa: E402
from simulst_tpu_torch.cli import latency_bleu as tlb  # noqa: E402
from simulst_tpu_torch.cli import stream_eval as tstream_cli  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.data.vocab import SPECIALS, Vocabulary  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mma as tmma  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.stream import simuleval_agent as sva  # noqa: E402
from simulst_tpu_torch.stream.evaluator import run_session  # noqa: E402
from simulst_tpu_torch.train import checkpoint as tckpt  # noqa: E402

SMALL = dict(input_feat=80, conv_channels=16, embed_dim=16, ffn_dim=32,
             encoder_layers=1, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=128, dropout=0.0, attention_dropout=0.0,
             activation_dropout=0.0, no_scale_embedding=True)
# 1.4, 1.5, 1.0 (a bucket of its own) and 1.45 s
SAMPLES = (22400, 24000, 16000, 23200)
MODES = {"batch": ["--batch-size", "3"],
         "scan": ["--batch-size", "3", "--scan-sessions"],
         "scan_no_ca": ["--batch-size", "3", "--scan-sessions",
                        "--no-ca-pass"]}


def _wave(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    wav = sum(a * np.sin(2 * np.pi * f * t) for a, f in
              zip(rng.uniform(0.05, 0.3, 3), rng.uniform(100, 3000, 3)))
    return np.clip(wav + 0.05 * rng.randn(n), -1, 1).astype(np.float32)


def _write_data(root):
    """A MuST-C-shaped manifest of zero features, global CMVN stats, a
    dictionary of 10 pieces, and four int16 wavs with references."""
    rows = tsyn.mustc_like_rows(16, seed=4, tmpdir=str(root), feat_dim=80)
    for r in rows:
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (root / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (root / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))
    np.savez(root / "gcmvn.npz", mean=np.zeros(80, np.float32),
             std=np.full(80, 4.0, np.float32))
    from scipy.io import wavfile
    paths = []
    for i, n in enumerate(SAMPLES):
        path = root / f"utt{i}.wav"
        wavfile.write(str(path), 16000,
                      np.round(_wave(40 + i, n) * 32767).astype(np.int16))
        paths.append(str(path))
    (root / "dev.wav_list").write_text("\n".join(paths) + "\n")
    (root / "dev.de").write_text("aaa bbb ccc\nddd eee\nfff\nggg hhh\n")


def _jax_tree(template, state):
    """The port's state_dict in the JAX parameter tree of `template`
    (compat/jax_bridge.load_jax_params, inverted)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for path, _ in paths:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        a = state[key].numpy()
        leaves.append(np.transpose(a, (2, 1, 0)) if a.ndim == 3 else a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Train the tiny CIF checkpoint, then run both CLIs in every mode.
    Returns (root, {mode: (port scores, JAX scores)})."""
    root = tmp_path_factory.mktemp("batched_cli")
    _write_data(root)
    small = {k: v for k, v in SMALL.items()}
    asr = ts2t.S2TEmformerModel(
        ts2t.S2TEmformerConfig(vocab_size=14, ctc_layer=True, **small),
        device="cpu", generator=torch.Generator().manual_seed(3))
    tckpt.save_checkpoint(str(root / "asr"), asr.state_dict(),
                          {"model": "s2t_emformer"})
    state = tcli.main([
        "--task", "st", "--model", "cif", "--loss", "cif",
        "--override", "cif_beta=1.0", "--override", "ctc_layer=true",
        "--loss-override", "ctc_factor=0.3",
        "--loss-override", "quant_factor=1.0",
        "--loss-override", "quant_type=align",
        "--data", str(root), "--device", "cpu", "--cmvn", "global",
        "--max-updates", "2", "--max-tokens", "1600", "--save-dir",
        str(root / "cif"), "--load-pretrained-encoder-from",
        str(root / "asr"), "--lr", "5e-4", "--warmup-updates", "4000",
        "--clip-norm", "10",
        *[f"--override={k}={v}" for k, v in SMALL.items()]])
    assert state.step == 2
    ckpt = str(root / "cif" / "checkpoint_last")
    params, meta = tckpt.load_checkpoint(ckpt)
    # the EOS row shrunk in both copies, so that the students write words
    params["decoder.embed_tokens.weight"][2] *= 0.1
    tckpt.save_checkpoint(ckpt, params, meta)
    jcfg = cfglib.from_dict(jcif.CIFConfig, {**meta["config"],
                                             "vocab_size": 14})
    jp = _jax_tree(jcif.CIFModel(jcfg).init(jax.random.PRNGKey(0)), params)
    base = ["--source", str(root / "dev.wav_list"), "--target",
            str(root / "dev.de"), "--checkpoint", ckpt, "--vocab",
            str(root / "spm_unigram.txt"), "--global-cmvn",
            str(root / "gcmvn.npz"), "--agent", "cif", "--fused",
            "--max-tgt-len", "100"]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SIMULST_JAX_CACHE", "0")
        mp.setattr(jbuild, "load_checkpoint", lambda path: (jp, meta))
        for mode, extra in MODES.items():
            port = tstream_cli.main(base + extra + [
                "--device", "cpu", "--output", str(root / "port" / mode)])
            want = jstream_cli.main(base + extra + [
                "--output", str(root / "jax" / mode)])
            out[mode] = (port, want)
    return root, out


def _instances(path):
    return [(x["prediction"], x["delays"], x["truncated"], x["mode"])
            for x in map(json.loads, path.read_text().splitlines())]


@pytest.mark.parametrize("mode", list(MODES))
def test_stream_eval_batched_matches_jax_cli(runs, mode):
    """Each mode's scores have the JAX CLI's keys, mode stamp, BLEU,
    latencies and truncation count, and its instances the JAX CLI's
    predictions, delays, flags and stamps; --scan-sessions without
    --no-ca-pass also writes instances_ca.log (step-wise)."""
    root, out = runs
    got, want = out[mode]
    assert set(got) == set(want)
    assert got["mode"] == want["mode"] == {
        "batch": "stepwise", "scan": "scan+stepwise_ca",
        "scan_no_ca": "scan"}[mode]
    for key in ("BLEU", "AL", "AP", "DAL"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert got["truncated"] == want["truncated"]
    assert json.loads((root / "port" / mode / "scores").read_text()) == got
    names = ["instances.log"] + (["instances_ca.log"] if mode == "scan"
                                 else [])
    for name in names:
        mine = _instances(root / "port" / mode / name)
        assert mine == _instances(root / "jax" / mode / name)
        assert len(mine) == len(SAMPLES)
    assert not (root / "port" / mode / "instances_ca.log").exists() or \
        mode == "scan"
    assert sum(len(x[0].split()) for x in _instances(
        root / "port" / mode / "instances.log")) > 3


def test_latency_bleu_matches_jax(runs, capsys):
    """cli/latency_bleu over the port's and the JAX CLI's result
    directories prints the same table and writes the same tsv."""
    root, _ = runs
    dirs = [str(root / side / mode) for side in ("port", "jax")
            for mode in MODES] + [str(root / "missing")]
    tlb.main(dirs + ["--tsv", str(root / "port.tsv")])
    mine = capsys.readouterr().out
    jlb.main(dirs + ["--tsv", str(root / "jax.tsv")])
    assert mine == capsys.readouterr().out
    assert (root / "port.tsv").read_text() == (root / "jax.tsv").read_text()
    lines = mine.splitlines()
    assert lines[0].split("\t") == ["system"] + tlb.COLUMNS
    assert len(lines) == 1 + 2 * len(MODES)


def test_stream_eval_profile_writes_a_trace(runs):
    """--profile DIR writes a torch.profiler (Chrome JSON) trace of one
    streaming session."""
    root, _ = runs
    prof = root / "profile"
    tstream_cli.main([
        "--source", str(root / "dev.wav_list"), "--target",
        str(root / "dev.de"), "--checkpoint",
        str(root / "cif" / "checkpoint_last"), "--vocab",
        str(root / "spm_unigram.txt"), "--global-cmvn",
        str(root / "gcmvn.npz"), "--agent", "cif", "--fused",
        "--max-utterances", "1", "--device", "cpu", "--profile", str(prof),
        "--output", str(root / "profiled")])
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]


# ---------------------------------------------------------------------------
# the SimulEval adapter
# ---------------------------------------------------------------------------

SR = 16000


class ListEntry:
    """simuleval's ListEntry surface that the protocol uses (front pop)."""

    def __init__(self):
        self.value = []

    def __len__(self):
        return len(self.value)

    def __iter__(self):
        return iter(self.value)

    def append(self, x):
        self.value.append(x)

    def pop(self):
        return self.value.pop(0)


def _mock_states():
    states = types.SimpleNamespace()
    states.units = types.SimpleNamespace(source=ListEntry(),
                                         target=ListEntry())
    states._finished_source = False
    states.finish_read = lambda: states._finished_source
    return states


def run_simuleval_session(agent, wav, max_actions=2000):
    """A mock SimulEval client / server event loop."""
    states = _mock_states()
    agent.initialize_states(states)
    unit_queue = ListEntry()
    pos, words = 0, []

    def handle_segment(seg_out):
        if seg_out is None:
            return False
        done = False
        for s in (seg_out if isinstance(seg_out, list) else [seg_out]):
            if s == sva.DEFAULT_EOS:
                done = True
            elif s:
                words.extend(s.split())
        return done

    for _ in range(max_actions):
        if agent.policy(states) == sva.READ_ACTION:
            n = int(round(agent.speech_segment_size / 1000.0 * SR))
            seg = wav[pos: pos + n]
            pos += len(seg)
            if pos >= len(wav):
                states._finished_source = True
            for u in agent.segment_to_units(list(seg), states):
                states.units.source.append(u)
            agent.update_states_read(states)
        else:
            unit = agent.predict(states)
            states.units.target.append(unit)
            unit_queue.append(unit)
            if handle_segment(agent.units_to_segment(unit_queue, states)):
                return words
    raise AssertionError("the mock SimulEval session did not terminate")


def _simuleval_agent(tmp_path, kind):
    """A 2 + 2-layer model (the final layer norm's scale at random, so
    that greedy decoding writes varied words) saved as a port checkpoint,
    behind the adapter on the CPU, its token buffer 32.  The SimulEval
    length cap (max_len_a x source units + max_len_b) sits above that
    buffer, so that the protocol and run_session stop at the same
    token."""
    symbols = SPECIALS + [f"▁w{i}" for i in range(16)] + \
        [f"x{i}" for i in range(4)]
    kw = dict(SMALL, encoder_layers=2, vocab_size=len(symbols))
    gen = torch.Generator().manual_seed(1)
    if kind == "cif":
        cfg = tcif.CIFConfig(**kw)
        model = tcif.CIFModel(cfg, device="cpu", generator=gen)
    else:
        cfg = tmma.MMAConfig(**kw, simul_attn_type="waitk_fixed_pre_decision",
                             waitk_lagging=2, fixed_pre_decision_ratio=2)
        model = tmma.MMAModel(cfg, device="cpu", generator=gen)
    state = model.state_dict()
    state["decoder.layer_norm.scale"] = torch.from_numpy(
        np.random.RandomState(3).randn(16).astype(np.float32) * 3.0)
    ckpt = str(tmp_path / f"ckpt_{kind}")
    tckpt.save_checkpoint(ckpt, state, {"model": "cif" if kind == "cif"
                                        else "mma",
                                        "config": cfglib.to_dict(cfg)})
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("".join(f"{s} 1\n" for s in symbols[4:]))
    assert Vocabulary.from_txt(str(vpath)).symbols == symbols
    args = types.SimpleNamespace(
        model_path=ckpt, tgt_splitter_path=str(vpath), agent_type=kind,
        model=None, global_stats=None, waitk=None, cif_beta=None,
        overshoot_weight=1.0, force_finish=False, max_len_a=10,
        max_len_b=1000, device="cpu")
    agent = sva.SimulSTAgent(args)
    agent.agent.acfg.max_tgt_len = 32    # as cli/stream_eval --max-tgt-len
    return agent


@pytest.mark.parametrize("kind", ["waitk", "cif"])
def test_simuleval_protocol_matches_run_session(tmp_path, kind):
    """The words through the SimulEval protocol (READ pulls
    speech_segment_size ms; WRITE pulls predict() into the unit queue,
    merged into words until DEFAULT_EOS) equal the built-in evaluator's
    run_session on the same agent and audio; the first READ asks for the
    first chunk's size, later READs the steady size."""
    agent = _simuleval_agent(tmp_path, kind)
    assert not sva.HAVE_SIMULEVAL and sva.READ_ACTION != sva.WRITE_ACTION
    cfg = agent.agent.cfg
    stride_ms = cfg.stride * 10
    assert agent.first_segment_size == (
        cfg.segment_length // cfg.stride
        + cfg.right_context // cfg.stride) * stride_ms + 15
    assert agent.steady_segment_size == (
        cfg.segment_length // cfg.stride) * stride_ms
    assert agent.speech_segment_size == agent.first_segment_size
    wav = _wave(50, int(SR * 1.2))
    words = run_simuleval_session(agent, wav)
    want = run_session(agent.agent, wav)[0]
    assert " ".join(words).split() == " ".join(want).split()
    assert len(want) > 1, want
