"""tools/synthetic_smoke.py, the port's tone-language smoke, on the CPU.

Its corpus against exp/smoke_synthetic.build_corpus (the JAX package's
script), at 24 + 4 utterances: the same manifests row for row but the
features, the same vocabulary, references and held-out wavs, and every
utterance's fbank within the data-preparation tests' tolerance
(tests/test_torch_port_data_prep.py `check_fbank`: on mel bins at least
1e-4 of their frame's energy the log-mel rtol 2e-5 / atol 2e-4,
everywhere the mel power within 1e-5 of the frame's energy), the global
CMVN statistics rtol 1e-4.  Then
its CIF leg through the real CLIs at a tiny depth: two CPU updates, the
checkpoint average and the fused, scanned, batched stream evaluation,
whose scores file holds finite BLEU and latencies (a two-update model
passes no threshold).
"""
import csv
import importlib
import math
import os
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "exp"))
import smoke_synthetic as jsmoke  # noqa: E402
import synthetic_smoke as tsmoke  # noqa: E402

FBANK_TOL = dict(rtol=2e-5, atol=2e-4)
N_TRAIN, N_DEV = 24, 4


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE))


def _feats(root):
    with zipfile.ZipFile(os.path.join(root, "fbank80.zip")) as zf:
        return {n[:-4]: np.load(zf.open(n)) for n in zf.namelist()}


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("tones")
    j = jsmoke.build_corpus(str(root / "jax"), N_TRAIN, N_DEV)
    t = tsmoke.build_corpus(str(root / "port"), N_TRAIN, N_DEV)
    return j, t


def test_corpus_matches_the_jax_script(corpora):
    j, t = corpora
    for split in ("train", "dev"):
        jr, tr = (_rows(os.path.join(r, f"{split}_st.tsv")) for r in (j, t))
        assert len(jr) == len(tr) == (N_TRAIN if split == "train" else N_DEV)
        for a, b in zip(jr, tr):
            assert {k: v for k, v in a.items() if k != "audio"} == \
                {k: v for k, v in b.items() if k != "audio"}
    for name in (tsmoke.VOCAB_FILE, "dev.de"):
        with open(os.path.join(j, name)) as a, open(os.path.join(t, name)) as b:
            assert a.read() == b.read(), name
    with open(os.path.join(j, "dev.wav_list")) as a, \
            open(os.path.join(t, "dev.wav_list")) as b:
        for pa, pb in zip(a.read().split(), b.read().split()):
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), pa
    jf, tf = _feats(j), _feats(t)
    assert sorted(jf) == sorted(tf)
    for uid in jf:
        assert jf[uid].shape == tf[uid].shape, uid
        p = np.exp(tf[uid].astype(np.float64))
        q = np.exp(jf[uid].astype(np.float64))
        energy = q.sum(axis=1, keepdims=True)
        strong = q >= 1e-4 * energy
        np.testing.assert_allclose(tf[uid][strong], jf[uid][strong],
                                   err_msg=uid, **FBANK_TOL)
        assert (np.abs(p - q) <= 1e-5 * energy).all(), uid
    js, ts = (np.load(os.path.join(r, "gcmvn.npz")) for r in (j, t))
    for key in ("mean", "std"):
        np.testing.assert_allclose(ts[key], js[key], rtol=1e-4, err_msg=key)


def test_cif_leg_runs_the_clis_on_the_cpu(corpora, tmp_path):
    """Two updates of the CIF leg at 1 + 1 layers, the average and the
    fused scanned batched evaluation, the CLIs called in this process."""
    _, data = corpora

    def run(module, argv):
        importlib.import_module(module).main(argv)

    scores = tsmoke.run_leg(
        str(tmp_path), data, "cif", run=run, updates=2, device="cpu",
        extra=["--override", "encoder_layers=1", "--override",
               "decoder_layers=1"], check=False)
    assert os.path.isfile(os.path.join(tmp_path, "ckpt_cif",
                                       "checkpoint_avg"))
    assert scores["mode"] == "scan+stepwise_ca"
    for key in ("BLEU", "AL", "AP", "DAL"):
        assert math.isfinite(scores[key]), (key, scores)
