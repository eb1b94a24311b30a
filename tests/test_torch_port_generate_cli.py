"""The MT teacher's decoding, `cli/generate.main` and the distillation
manifest of simulst_tpu_torch vs the JAX package, on the CPU:
`decode_batch_mt` token for token at B = 2, beam 1 and beam 3; `main`'s
whole output (S-, T-, D- lines and the SCORE line) on a tiny synthetic
manifest with a .txt dictionary, for a CIF checkpoint (--task asr,
--scoring wer) and an MT one (--task mt, --scoring bleu); `data/kd.py`'s
parse and manifest rewrite on a fabricated generate output.

Small models: 2 + 2 layers, width 16, 2 heads, FFN 32, vocab 24 (20
words of the manifest and the 4 specials); JAX init bridged to the port,
the decoder's final layer norm scale drawn at random (N(0, 9)); fp32 with
jax_default_matmul_precision float32 (tests/conftest.py); no dropout.
The JAX `main` reads its parameters through a stand-in for its orbax
`load_checkpoint` (the tree and the metadata it would restore); the
port's reads a checkpoint file written by its `save_checkpoint`.  Tokens,
lines and scores must be equal.  No near-tie can flip a token here: on
the port's side, neighbouring candidates lie more than 1e-3 apart at
every beam top-k cut (4e-3 for `decode_batch_mt`, whose greedy steps'
top-2 logit gaps exceed 1e-2), ten times the port's 1e-4 stack
tolerance and a thousand times what its logits differ from JAX's.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu import config as jcfglib  # noqa: E402
from simulst_tpu.cli import generate as jgen  # noqa: E402
from simulst_tpu.data import kd as jkd  # noqa: E402
from simulst_tpu.decode.beam import BeamConfig as JBeam  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mt_transformer as jmt  # noqa: E402
from simulst_tpu_torch import config as tcfglib  # noqa: E402
from simulst_tpu_torch.cli import generate as tgen  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import kd as tkd  # noqa: E402
from simulst_tpu_torch.data import manifest as mf  # noqa: E402
from simulst_tpu_torch.data.synthetic import mustc_like_rows  # noqa: E402
from simulst_tpu_torch.decode.beam import BeamConfig as TBeam  # noqa: E402
from simulst_tpu_torch.models import cif as tcif  # noqa: E402
from simulst_tpu_torch.models import mt_transformer as tmt  # noqa: E402
from simulst_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

MT = dict(vocab_size=24, embed_dim=16, ffn_dim=32, encoder_layers=2,
          decoder_layers=2, num_heads=2, dropout=0.0, attention_dropout=0.0,
          activation_dropout=0.0)
CIF = dict(vocab_size=24, input_feat=8, conv_channels=16, embed_dim=16,
           ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
           decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
           left_context=32, right_context=8, max_memory=2,
           max_target_positions=64, dropout=0.0, attention_dropout=0.0,
           activation_dropout=0.0, no_scale_embedding=True)
FAMILIES = {"mt_transformer": (jmt.MTTransformerModel, jmt.MTConfig,
                               tmt.MTTransformerModel, tmt.MTConfig, MT),
            "cif": (jcif.CIFModel, jcif.CIFConfig, tcif.CIFModel,
                    tcif.CIFConfig, CIF)}


def _pair(name):
    """(JAX model, params, port model) with one init."""
    jmodel_cls, jcfg_cls, tmodel_cls, tcfg_cls, kw = FAMILIES[name]
    jmodel = jmodel_cls(jcfg_cls(**kw))
    jp = jmodel.init(jax.random.PRNGKey(0))
    jp["decoder"]["layer_norm"]["scale"] = jnp.asarray(
        np.random.RandomState(3).randn(16).astype(np.float32) * 3.0)
    tmodel = tmodel_cls(tcfg_cls(**kw), device="cpu")
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    return jmodel, jp, tmodel.eval()


@pytest.fixture(scope="module")
def models():
    return {name: _pair(name) for name in FAMILIES}


@pytest.mark.parametrize("beam", [1, 3])
def test_decode_batch_mt_matches_jax(models, beam):
    jmodel, jp, tmodel = models["mt_transformer"]
    rng = np.random.RandomState(2)
    src = np.ones((2, 9), np.int64)
    for j, n in enumerate((9, 6)):
        src[j, :n] = np.append(rng.randint(4, 24, n - 1), 2)
    kw = dict(beam_size=beam, max_len=8)
    want = jgen.decode_batch_mt(jmodel, jp, {"src_tokens": src}, JBeam(**kw))
    with torch.no_grad():
        got = tgen.decode_batch_mt(tmodel, {"src_tokens": src}, TBeam(**kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    """tst-COMMON_st.tsv of the first 3 synthetic MuST-C-like rows under 2.56
    s (one 256-frame bucket), their features seeded noise of 8 bins, and
    spm_words.txt of 20 words, theirs first."""
    root = tmp_path_factory.mktemp("gen")
    rows = [r for r in mustc_like_rows(80, seed=1, tmpdir=str(root),
                                       feat_dim=8)
            if int(r["n_frames"]) <= 256][:3]
    rng = np.random.RandomState(7)
    specs = mf.create_feature_zip(
        {r["id"]: rng.randn(int(r["n_frames"]), 8).astype(np.float32)
         for r in rows}, str(root / "feats.zip"))
    for r in rows:
        r["audio"] = specs[r["id"]]
    mf.save_tsv(rows, str(root / "tst-COMMON_st.tsv"))
    words = sorted({w for r in rows for w in r["tgt_text"].split()})[:20]
    words += [f"filler{i}" for i in range(20 - len(words))]
    (root / "spm_words.txt").write_text("".join(f"▁{w} 1\n" for w in words))
    return root


@pytest.mark.parametrize("name,task,scoring,beam", [
    ("cif", "asr", "wer", 3), ("mt_transformer", "mt", "bleu", 2)])
def test_main_writes_jax_lines_and_score(models, manifest, tmp_path,
                                         monkeypatch, name, task, scoring,
                                         beam):
    jmodel, jp, tmodel = models[name]
    monkeypatch.setenv("SIMULST_JAX_CACHE", "0")
    monkeypatch.setattr(jgen, "load_checkpoint", lambda path: (jp, {
        "model": name, "config": jcfglib.to_dict(jmodel.cfg)}))
    ckpt = tmp_path / "checkpoint_last"
    save_checkpoint(str(ckpt), tmodel.state_dict(), {
        "model": name, "config": tcfglib.to_dict(tmodel.cfg)})
    argv = ["--data", str(manifest), "--checkpoint", str(ckpt), "--task",
            task, "--beam", str(beam), "--max-len", "8", "--scoring",
            scoring]
    want = jgen.main(argv + ["--output", str(tmp_path / "jax.txt")])
    got = tgen.main(argv + ["--output", str(tmp_path / "port.txt"),
                            "--device", "cpu"])
    assert got == want
    lines = (tmp_path / "port.txt").read_text().splitlines()
    assert lines == (tmp_path / "jax.txt").read_text().splitlines()
    assert lines[-1] == f"SCORE\t{scoring}\t{want:.2f}"
    assert sum(line.startswith("D-") for line in lines) == 3


def test_distillation_manifest_matches_jax(tmp_path):
    """D- lines of a fabricated generate output (out of order, one id
    missing, an empty hypothesis) replace tgt_text by row index."""
    rows = [{"id": f"u{i}", "src_text": f"s {i}", "tgt_text": f"t {i}"}
            for i in range(4)]
    mf.save_tsv(rows, str(tmp_path / "train_st.tsv"))
    out = ["S-2\ts 2", "T-2\tt 2", "D-2\t0.0\tdrei zwei", "D-0\t0.0\tnull",
           "H-1\t-0.5\tignored", "D-3\t0.0", "SCORE\tbleu\t1.00"]
    (tmp_path / "gen.txt").write_text("\n".join(out) + "\n")
    assert tkd.parse_generation_output(out) == \
        jkd.parse_generation_output(out) == {2: "drei zwei", 0: "null",
                                             3: ""}
    missing = [kd.create_distillation_tsv(
        str(tmp_path / "train_st.tsv"), str(tmp_path / "gen.txt"),
        str(tmp_path / f"{name}.tsv")) for name, kd in (("port", tkd),
                                                          ("jax", jkd))]
    assert missing == [1, 1]
    assert (tmp_path / "port.tsv").read_bytes() == \
        (tmp_path / "jax.tsv").read_bytes()
    assert [r["tgt_text"] for r in mf.load_tsv(str(tmp_path / "port.tsv"))] \
        == ["null", "t 1", "drei zwei", ""]


def test_main_rejects_an_unported_model(manifest, tmp_path):
    """Every model of the JAX registry is ported: a name outside it (the
    JAX module's file name, not its registry name) is refused."""
    ckpt = tmp_path / "checkpoint_last"
    save_checkpoint(str(ckpt), {}, {"model": "s2t_convpos", "config": {}})
    with pytest.raises(ValueError, match="unknown model 's2t_convpos'"):
        tgen.main(["--data", str(manifest), "--checkpoint", str(ckpt),
                   "--device", "cpu"])
