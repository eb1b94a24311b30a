"""The data preparation of simulst_tpu_torch vs the JAX package, on the CPU.

The native SentencePiece (data/spm.py: the ModelProto bytes, Viterbi ids
and the unigram trainer's pieces equal JAX's; `Vocabulary.from_spm` and
`build` without the sentencepiece package), the MuST-C segment-list reader
and config writer against PyYAML, the MuST-C preparation of a seeded
synthetic tree (two splits of int16 tone audio: data/synthetic
`write_mustc_tree`) against JAX's `process_split`, the global CMVN, the
long-utterance split, the simul lists and `cli/migrate_data_path`, and the
native batch loader (data/native.py, built with g++) against JAX's
`_load_feats` in every CMVN mode.  Everything is equal but the fbank,
which runs through ops/fbank in fp32 on the CPU against JAX's numpy fbank
(`check_fbank`): on mel bins at least 1e-4 of their frame's mel energy
(-40 dB) the log-mel within tests/test_torch_port_ops.py's tolerance
(rtol 2e-5, atol 2e-4), on every bin the mel power within 1e-5 of the
frame's mel energy.  A pure tone puts bins 60-100 dB under the frame's
peak, where an fp32 FFT's error (about 1e-7 of the frame's energy, spread
over every bin) moves the log by up to 1e-2: the JAX package's own fp32
fbank (`fbank_jax`) departs from its numpy fbank there by as much
(1.3e-6 of the frame's energy at most on this audio, the port's too).
"""
import os
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
yaml = pytest.importorskip("yaml")

from simulst_tpu.cli import migrate_data_path as jmigrate  # noqa: E402
from simulst_tpu.cli import prep_mustc as jprep  # noqa: E402
from simulst_tpu.data import dataset as jds  # noqa: E402
from simulst_tpu.data import mustc as jmustc  # noqa: E402
from simulst_tpu.data import spm as jspm  # noqa: E402
from simulst_tpu.data.vocab import Vocabulary as JVocab  # noqa: E402
from simulst_tpu_torch.cli import migrate_data_path as tmigrate  # noqa: E402
from simulst_tpu_torch.cli import prep_mustc as tprep  # noqa: E402
from simulst_tpu_torch.data import dataset as tds  # noqa: E402
from simulst_tpu_torch.data import manifest as tmf  # noqa: E402
from simulst_tpu_torch.data import mustc as tmustc  # noqa: E402
from simulst_tpu_torch.data import native as tnative  # noqa: E402
from simulst_tpu_torch.data import spm as tspm  # noqa: E402
from simulst_tpu_torch.data.synthetic import write_mustc_tree  # noqa: E402
from simulst_tpu_torch.data.vocab import Vocabulary as TVocab  # noqa: E402

FBANK_TOL = dict(rtol=2e-5, atol=2e-4)
VOCAB_SIZE = 60


def check_fbank(ours, ref, name):
    """log-mel within FBANK_TOL on bins >= -40 dB of their frame's mel
    energy; mel power within 1e-5 of the frame's energy everywhere."""
    p, q = np.exp(ours.astype(np.float64)), np.exp(ref.astype(np.float64))
    energy = q.sum(axis=1, keepdims=True)
    strong = q >= 1e-4 * energy
    np.testing.assert_allclose(ours[strong], ref[strong], err_msg=name,
                               **FBANK_TOL)
    assert (np.abs(p - q) <= 1e-5 * energy).all(), name


def _text(seed, n=40):
    rng = np.random.RandomState(seed)
    words = ["stream", "streams", "streaming", "speech", "the", "there",
             "translate", "translation", "model", "models", "Über", "ﬁne"]
    return [" ".join(words[i] for i in rng.randint(0, len(words),
                                                    rng.randint(1, 9)))
            for _ in range(n)]


@pytest.fixture(scope="module")
def trained():
    texts = _text(0)
    return texts, jspm.train_unigram(texts, vocab_size=VOCAB_SIZE,
                                     user_defined=["(Applause)"])


def test_train_unigram_pieces_equal_jax(trained):
    texts, jpieces = trained
    assert tspm.train_unigram(texts, vocab_size=VOCAB_SIZE,
                              user_defined=["(Applause)"]) == jpieces


def test_model_proto_bytes_and_round_trip_equal_jax(trained, tmp_path):
    _, pieces = trained
    tspm.save_model(str(tmp_path / "t.model"), pieces)
    jspm.save_model(str(tmp_path / "j.model"), pieces)
    assert (tmp_path / "t.model").read_bytes() == \
        (tmp_path / "j.model").read_bytes()
    got = tspm.load_model(str(tmp_path / "j.model"))
    assert got == jspm.load_model(str(tmp_path / "j.model"))
    assert [(p, t) for p, _, t in got] == [(p, t) for p, _, t in pieces]
    np.testing.assert_allclose([s for _, s, _ in got],
                               [s for _, s, _ in pieces], rtol=1e-6)


def test_viterbi_ids_equal_jax(trained):
    _, pieces = trained
    tm, jm = tspm.UnigramModel(pieces), jspm.UnigramModel(pieces)
    for line in _text(1, 30) + ["unseen zq words", "  ", "(Applause) the"]:
        assert tm.encode(line, out_type=int) == jm.encode(line, out_type=int)
        assert tm.encode(line) == jm.encode(line)


def test_vocabulary_without_sentencepiece_equals_jax(tmp_path, monkeypatch):
    """from_spm and build go through data/spm.py when sentencepiece cannot
    be imported: the same .model / .txt files and ids as JAX's."""
    monkeypatch.setitem(sys.modules, "sentencepiece", None)
    texts = _text(2)
    tv = TVocab.build(texts, vocab_size=VOCAB_SIZE,
                      save_prefix=str(tmp_path / "t"))
    jv = JVocab.build(texts, vocab_size=VOCAB_SIZE,
                      save_prefix=str(tmp_path / "j"))
    assert tv.symbols == jv.symbols
    for ext in (".model", ".txt"):
        assert (tmp_path / f"t{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    loaded = TVocab.from_spm(str(tmp_path / "j.model"))
    assert isinstance(loaded.spm, tspm.UnigramModel)
    for line in _text(3, 10):
        assert loaded.encode(line) == jv.encode(line)


def test_segment_yaml_reader_equals_safe_load():
    text = (
        "- {duration: 3.520000, offset: 16.550000, rW: 9, uW: 0, "
        "speaker_id: spk.1, wav: ted_1.wav}\n"
        "\n"
        "- {duration: 12, offset: .5, rW: -3, uW: 1_000, speaker_id: "
        "'spk, 2', wav: \"ted 2.wav\", a: ~, b: yes, c: 1e5, d: 0.5e+3, "
        "e: Off, f: null, g: 'it''s'}\n")
    assert tmustc.load_segment_yaml(text) == yaml.safe_load(text)


def test_data_config_equals_safe_dump(tmp_path):
    tmustc.write_config(str(tmp_path), 4096)
    text = (tmp_path / "config_st.yaml").read_text()
    assert text == yaml.safe_dump(tmustc.data_config(4096))
    (tmp_path / "j").mkdir()
    jmustc.write_config(str(tmp_path / "j"), 4096)
    assert text == (tmp_path / "j" / "config_st.yaml").read_text()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """One synthetic tree prepared by both packages' CLIs."""
    root = tmp_path_factory.mktemp("mustc")
    write_mustc_tree(str(root), "train", 10, seed=1, min_s=0.6, max_s=1.6)
    write_mustc_tree(str(root), "tst-COMMON", 6, seed=2, min_s=0.6,
                     max_s=1.6)
    out = {}
    for name, prep, extra in (("jax", jprep.main, []),
                              ("port", tprep.main, ["--device", "cpu"])):
        out[name] = str(root / name)
        prep(["--data-root", str(root), "--out-dir", out[name],
              "--splits", "train", "tst-COMMON", "--vocab-size",
              str(VOCAB_SIZE), "--long-seconds", "3"] + extra)
    return root, out


@pytest.mark.parametrize("split", ["train", "tst-COMMON"])
def test_process_split_rows_and_features_equal_jax(prepared, split):
    _, out = prepared
    jrows = tmf.load_tsv(os.path.join(out["jax"], f"{split}_st.tsv"))
    trows = tmf.load_tsv(os.path.join(out["port"], f"{split}_st.tsv"))
    assert len(trows) == len(jrows) > 0
    for t, j in zip(trows, jrows):
        assert {k: v for k, v in t.items() if k != "audio"} == \
            {k: v for k, v in j.items() if k != "audio"}
        check_fbank(tmf.read_feature(t["audio"]),
                    tmf.read_feature(j["audio"]), t["id"])


def test_prep_vocab_gcmvn_config_and_long_split_equal_jax(prepared):
    root, out = prepared
    name = f"spm_unigram{VOCAB_SIZE}_st"
    for f in (name + ".model", name + ".txt", "config_st.yaml",
              "tst-COMMON-3s.de"):
        with open(os.path.join(out["port"], f), "rb") as a, \
                open(os.path.join(out["jax"], f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(out["port"], "tst-COMMON-3s.wav_list")) as a, \
            open(os.path.join(out["jax"], "tst-COMMON-3s.wav_list")) as b:
        wavs = [(x.strip(), y.strip()) for x, y in zip(a, b)]
    assert len(wavs) >= 2
    for x, y in wavs:
        assert os.path.basename(x) == os.path.basename(y)
        with open(x, "rb") as fx, open(y, "rb") as fy:
            assert fx.read() == fy.read()
    # gcmvn: equal over the same features; over the two fbanks within
    # 1e-4 (their means over frames of check_fbank's differences)
    t, j = (np.load(os.path.join(out[k], "gcmvn.npz")) for k in ("port",
                                                               "jax"))
    for key in ("mean", "std"):
        np.testing.assert_allclose(t[key], j[key], rtol=0, atol=1e-4)
    rows = tmf.load_tsv(os.path.join(out["jax"], "train_st.tsv"))
    tmustc.write_gcmvn(str(root), rows)
    same = np.load(str(root / "gcmvn.npz"))
    for key in ("mean", "std"):
        np.testing.assert_array_equal(same[key], j[key])


def test_parse_segments_and_long_groups_equal_jax(prepared):
    root, _ = prepared
    tseg = tmustc.parse_segments(str(root), "train", "en", "de")
    jseg = jmustc.parse_segments(str(root), "train", "en", "de")
    assert tseg == jseg
    for secs in (1.0, 2.5, 100.0):
        assert tmustc.build_long_utterances(tseg, secs) == \
            jmustc.build_long_utterances(jseg, secs)


def test_simul_lists_and_migrate_data_path_equal_jax(prepared, tmp_path):
    _, out = prepared
    rows = tmf.load_tsv(os.path.join(out["port"], "tst-COMMON_st.tsv"))
    tmustc.write_simul_lists(rows, "/data/wavs", str(tmp_path / "t"))
    jmustc.write_simul_lists(rows, "/data/wavs", str(tmp_path / "j"))
    for ext in (".wav_list", ".de"):
        assert (tmp_path / f"t{ext}").read_text() == \
            (tmp_path / f"j{ext}").read_text()
    for name, migrate in (("t", tmigrate.main), ("j", jmigrate.main)):
        path = tmp_path / f"{name}.tsv"
        tmf.save_tsv(rows, str(path))
        migrate([str(path), "--old", out["port"], "--new", "/moved"])
    assert (tmp_path / "t.tsv").read_text() == \
        (tmp_path / "j.tsv").read_text()
    assert "/moved/fbank80_tst-COMMON.zip:" in (tmp_path / "t.tsv").read_text()


@pytest.mark.parametrize("cmvn", ["none", "utterance", "global"])
def test_native_loader_equals_jax_load_feats(prepared, cmvn):
    """The port's batcher loads zip members through its own C++ build; the
    JAX package's _load_feats through its own.  Every CMVN mode, one
    utterance cut by the frame bucket."""
    _, out = prepared
    rows = tmf.load_tsv(os.path.join(out["jax"], "train_st.tsv"))[:5]
    with np.load(os.path.join(out["jax"], "gcmvn.npz")) as f:
        stats = {"mean": f["mean"], "std": f["std"]}
    tb = min(int(r["n_frames"]) for r in rows) + 3
    results = []
    for ds_mod, vocab in ((tds, TVocab(["<s>", "<pad>", "</s>", "<unk>"])),
                          (jds, JVocab(["<s>", "<pad>", "</s>", "<unk>"]))):
        cfg = ds_mod.BatcherConfig(cmvn=cmvn)
        ds = ds_mod.SpeechDataset(rows, vocab, cfg, global_stats=stats)
        feats = np.zeros((8, tb, 80), np.float32)
        results.append((ds_mod._load_feats(ds, rows, feats, cfg), feats))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_array_equal(results[0][1], results[1][1])
    assert tnative.library_path().exists()


def test_native_loader_raises_on_bad_input(prepared, tmp_path):
    _, out = prepared
    feats = np.zeros((1, 8, 80), np.float32)
    with pytest.raises(ValueError, match="not a zip member"):
        tnative.load_feature_batch([str(tmp_path / "x.npy")], feats)
    spec = tmf.load_tsv(os.path.join(out["port"], "train_st.tsv"))[0]["audio"]
    path, offset, length = spec.rsplit(":", 2)
    bad = f"{path}:{int(offset) + 1}:{length}"      # not at the .npy header
    with pytest.raises(RuntimeError, match="could not read"):
        tnative.load_feature_batch([bad], feats)
