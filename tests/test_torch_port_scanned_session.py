"""Whole-session (scanned) streaming of simulst_tpu_torch on the CPU:
`FusedBatchSession.process_session_wavs` (the fbank of the whole sample
matrix on the device, then `fused.make_scanned_runner`) against the
`process_chunk_batch` loop, int16 staging and mixed-dtype buckets,
`evaluate_batched(scan=True)` against the port's B = 1 `evaluate` and
JAX's scanned `evaluate_batched`, the per-example overflow flags against
B = 1 sessions and JAX's, and `merge_honest_ca` against JAX's.

Small models and weights as tests/test_torch_port_batched_stream.py
(JAX init bridged to the port, the final layer norm's scale at random and
EOS's row shrunk).  Tolerances: tokens, words, flags and mode stamps
exactly; delays atol 1e-6; scores rtol 1e-12.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

from simulst_tpu.stream import evaluator as jeval  # noqa: E402
from simulst_tpu_torch.stream import agents as tagents  # noqa: E402
from simulst_tpu_torch.stream import evaluator as teval  # noqa: E402
from test_torch_port_batched_stream import (  # noqa: E402
    _agents, _audios, _log, _wave, case_agents,
    hold_against_b1_and_jax, mma_gaps)


def _chunk_lists(agent, wavs):
    n_first, n_steady, n_chunks, _ = tagents._session_schedule(agent.cfg,
                                                               wavs)
    cuts = [0] + [n_first + k * n_steady for k in range(n_chunks)]
    return n_chunks, [[w[a:min(b, len(w))] for a, b in zip(cuts, cuts[1:])]
                      for w in wavs]


def _bucket(seed=7):
    """Three 0.9-1.0 s utterances of one chunk-count bucket (final chunks
    of other sizes)."""
    return [_wave(seed + i, int(16000 * s))
            for i, s in enumerate((1.0, 0.9, 0.97))]


@pytest.mark.parametrize("kind", ["cif", "waitk"])
def test_process_session_equals_chunk_loop_and_wavs(kind):
    """The whole session in one call (process_session_wavs on the raw
    waveforms) equals the process_chunk_batch loop token for token, chunk
    by chunk."""
    _, agent = _agents(kind)
    wavs = _bucket()
    n_chunks, lists = _chunk_lists(agent, wavs)
    assert n_chunks >= 3, "a steady chunk between the first and the last"
    sess = agent.new_batched_session(3)
    loop = [sess.process_chunk_batch([c[k] for c in lists],
                                     finished=k == n_chunks - 1)
            for k in range(n_chunks)]
    loop = [[loop[k][i] for k in range(n_chunks)] for i in range(3)]
    assert agent.new_batched_session(3).process_session_wavs(wavs) == loop
    assert sum(len(t) for toks in loop for t in toks) > 6, loop


def test_int16_staging_and_mixed_buckets_equal_float():
    """int16 PCM is staged as an int16 matrix (cast on the device) and
    gives the session of the same samples as fp32 in [-1, 1]; a bucket
    that mixes int16 and fp32 wavs is staged as fp32 and gives it too."""
    _, agent = _agents("cif")
    rng = np.random.RandomState(3)
    i16 = [(rng.randn(int(16000 * s)) * 1500).astype(np.int16)
           for s in (1.0, 0.95, 1.0)]
    f32 = [w.astype(np.float32) / 2 ** 15 for w in i16]
    ref = agent.new_batched_session(3).process_session_wavs(f32)
    staged = tagents.stage_session_wavs(agent, i16)
    assert staged.wav_mat.dtype == torch.int16
    assert staged.n_valid is not None        # the final chunks differ
    assert agent.new_batched_session(3).process_session_wavs(i16) == ref
    mixed = [i16[0], f32[1], i16[2]]
    assert tagents.stage_session_wavs(agent, mixed).wav_mat.dtype == \
        torch.float32
    assert agent.new_batched_session(3).process_session_wavs(mixed) == ref
    assert sum(len(t) for toks in ref for t in toks) > 3, ref


@pytest.mark.parametrize("kind", ["cif", "waitk", "ilk", "cif_full"])
def test_evaluate_batched_scan_matches_b1_and_jax(kind, tmp_path,
                                                  monkeypatch):
    """evaluate_batched(scan=True) at batch_size 3 over the 0.5 / 0.9 /
    1.0 / 1.3 / 1.0 s audio (a single-chunk-free schedule; buckets of 1, 3
    and 1): words, delays and flags equal the port's B = 1 evaluate and
    JAX's scanned evaluate_batched; every instance is stamped "scan".
    MMA's learned heads ("ilk"): the examples write mid-stream and part
    ways, every B = 1 token more than 1e-4 over its runner-up.  A full
    token buffer ("cif_full"): as `hold_against_b1_and_jax` says."""
    jagent, agent = case_agents(kind)
    wavs = _audios()
    refs = ["the cats sat", "a dog ran far", "home", "big cats", "and back"]
    paths = {k: str(tmp_path / f"{k}.log")
             for k in ("b1", "scan", "jax", "jax_b1")}
    gaps = mma_gaps(monkeypatch) if kind == "ilk" else [1.0]
    teval.evaluate(agent, wavs, refs, log_path=paths["b1"])
    assert min(gaps) > 1e-4
    got = teval.evaluate_batched(agent, wavs, refs, batch_size=3,
                                 log_path=paths["scan"], scan=True)
    hold_against_b1_and_jax(kind, jagent, wavs, refs, paths, got, scan=True)


def test_overflow_flags_per_example(tmp_path):
    """A batch with 0.5, 2.0, 1.9 and 1.0 s utterances (buckets of 1, 2
    and 1) and room for 32 encoder frames and 48 tokens (EOS's row as
    initialised, so that the token buffer does not fill): each example's
    truncated flag and words, step-wise and scanned, equal its B = 1
    session's and JAX's batched evaluator's; the 2 s utterances overflow,
    the others do not."""
    acfg = dict(max_src_frames=32, max_tgt_len=48)
    jagent, agent = _agents("waitk", acfg, eos_scale=1.0)
    wavs = [_wave(30, 8000), _wave(31, 32000), _wave(32, 30400),
            _wave(33, 16000)]
    paths = {k: str(tmp_path / f"{k}.log")
             for k in ("b1", "step", "scan", "jax")}
    teval.evaluate(agent, wavs, log_path=paths["b1"])
    for scan in (False, True):
        scores = teval.evaluate_batched(
            agent, wavs, batch_size=3, scan=scan,
            log_path=paths["scan" if scan else "step"])
    jeval.evaluate_batched(jagent, wavs, batch_size=3, log_path=paths["jax"])
    want = _log(paths["jax"])
    flags = [x[2] for x in want]
    assert flags == [False, True, True, False], flags
    assert scores["truncated"] == 2
    for name in ("b1", "step", "scan"):
        got = _log(paths[name])
        assert [x[2] for x in got] == flags, name
        assert [x[0] for x in got] == [x[0] for x in want], name


def test_merge_honest_ca_matches_jax():
    scan = {"mode": "scan", "BLEU": 12.5, "AL": 900.0, "AL_CA": 5000.0,
            "AP": 0.7, "AP_CA": 3.0, "DAL": 1000.0, "DAL_CA": 6000.0,
            "truncated": 1}
    step = {"mode": "stepwise", "BLEU": 12.5, "AL": 900.0, "AL_CA": 1200.0,
            "AP": 0.7, "AP_CA": 0.9, "DAL": 1000.0, "DAL_CA": 1300.0,
            "truncated": 1}
    got = teval.merge_honest_ca(scan, step)
    assert got == jeval.merge_honest_ca(scan, step)
    assert got["mode"] == "scan+stepwise_ca" and got["AL_CA"] == 1200.0
    assert json.dumps(got, sort_keys=True) == json.dumps(
        jeval.merge_honest_ca(scan, step), sort_keys=True)
