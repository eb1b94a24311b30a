"""The remaining training options and the interactive and visualisation
CLIs of simulst_tpu_torch vs the JAX package, on the CPU.

--mtl: the batcher's `src_target` batch for batch, and the joint-CTC loss
with the CTC on the transcripts (loss and CTC term rtol 1e-5, every
gradient within 1e-4 of its largest entry) on a 2 + 2-layer width-64
s2t_emformer with its CTC head, JAX init bridged.  cli/train with --mtl,
--encoder-freezing-updates 2, --tensorboard, --wandb-project and
--profile on a tiny manifest through the native loader: the encoder
unchanged after two updates and moved by the third, the decoder moved by
the first; the TensorBoard events (read with tensorboard's Event proto,
the framing's CRC-32C checked with google_crc32c) hold the jsonl log's
validation scalars; the profiler trace is Chrome JSON; wandb, which is
not installed here, is skipped with JAX's message.

cli/interactive (speech: two tone wavs, fbank and utterance CMVN; mt: two
text lines) and cli/visualize (CIF alphas, the CTC best alignment and its
boundaries, the ASCII timeline) against the JAX CLIs on one tiny CIF / MT
checkpoint (2 + 2 layers, width 16, 80 fbank features, vocab 24, the
decoder's final layer norm scale drawn N(0, 9) so that no near-tie flips
a token), the JAX CLIs reading the same tree through a stand-in for their
orbax loader: the H- lines and the timelines equal, the npz states and
boundaries equal and the alphas atol 1e-5.
"""
import glob
import io
import json
import struct

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
google_crc32c = pytest.importorskip("google_crc32c")

from simulst_tpu import config as jcfglib  # noqa: E402
from simulst_tpu.cli import interactive as jint  # noqa: E402
from simulst_tpu.cli import visualize as jvis  # noqa: E402
from simulst_tpu.data import dataset as jds  # noqa: E402
from simulst_tpu.data.vocab import Vocabulary as JVocab  # noqa: E402
from simulst_tpu.losses import joint_ctc as jjc  # noqa: E402
from simulst_tpu.models import cif as jcif  # noqa: E402
from simulst_tpu.models import mt_transformer as jmt  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu_torch.cli import interactive as tint  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.cli import visualize as tvis  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import dataset as tds  # noqa: E402
from simulst_tpu_torch.data import manifest as mf  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.data.vocab import Vocabulary as TVocab  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.train.checkpoint import (load_checkpoint,  # noqa: E402
                                                save_checkpoint)

SMALL = dict(vocab_size=40, input_feat=8, conv_channels=16, embed_dim=64,
             ffn_dim=128, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=128, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True, dropout=0.0,
             attention_dropout=0.0, activation_dropout=0.0)
MTL_ARGS = ["--task", "st", "--model", "s2t_emformer", "--loss", "joint_ctc",
            "--override", "ctc_layer=true", "--mtl", "--no-specaugment"]


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _mtl_rows(tmpdir, n, seed):
    """MuST-C-shaped rows whose translations are their transcripts' words
    reversed and cut, so that the two targets differ in content and
    length."""
    rows = tsyn.mustc_like_rows(n, seed=seed, tmpdir=tmpdir, feat_dim=8)
    for r in rows:
        r["n_frames"] = str(min(int(r["n_frames"]), 400))
        words = r["src_text"].split()
        r["tgt_text"] = " ".join(words[::-1][:max(1, len(words) // 2)])
    return rows


def _syms(rows):
    """The specials, then every word of the rows as a piece."""
    return ["<s>", "<pad>", "</s>", "<unk>"] + sorted(
        {"▁" + w for r in rows for w in r["src_text"].split()})


def test_mtl_batches_equal_jax(tmp_path):
    rows = _mtl_rows(str(tmp_path), 40, 3)
    syms = _syms(rows)
    jb = list(jds.make_batches(jds.SpeechDataset(
        rows, JVocab(syms), jds.BatcherConfig(max_tokens=3000), "tgt_text",
        mtl_src=True), epoch=1, num_shards=1, shard_id=0))
    tb = list(tds.make_batches(tds.SpeechDataset(
        rows, TVocab(syms), tds.BatcherConfig(max_tokens=3000), "tgt_text",
        mtl_src=True), epoch=1))
    assert len(jb) == len(tb) > 3
    for a, b in zip(jb, tb):
        assert sorted(a) == sorted(b) and a["ids"] == b["ids"]
        assert not np.array_equal(a["src_target"][:, :3], a["target"][:, :3])
        for key in ("feats", "feat_lengths", "target", "prev_tokens",
                    "src_target"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_mtl_loss_and_every_gradient_match_jax():
    """CE on the translations, CTC on src_target: loss and CTC term rtol
    1e-5, every gradient within 1e-4 of its largest entry (a key bias's of
    its weight's)."""
    rng = np.random.RandomState(9)
    batch = {"feats": _rand(rng, 2, 128, 8),
             "feat_lengths": np.array([128, 90], np.int32),
             "target": np.ones((2, 8), np.int32),
             "prev_tokens": np.ones((2, 8), np.int32),
             "src_target": np.ones((2, 16), np.int32)}
    for j, (n, s) in enumerate(((7, 12), (4, 9))):
        toks = np.append(rng.randint(4, 40, n), 2)
        batch["target"][j, :n + 1] = toks
        batch["prev_tokens"][j, :n + 1] = np.append(2, toks[:-1])
        batch["src_target"][j, :s + 1] = np.append(rng.randint(4, 40, s), 2)
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**SMALL))
    jp = jmodel.init(jax.random.PRNGKey(1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(params):
        logits, extra = jmodel.forward(params, jb["feats"],
                                       jb["feat_lengths"], jb["prev_tokens"])
        return jjc.joint_ctc_loss(logits, extra, jb["target"],
                                  jjc.JointCTCConfig(),
                                  ctc_target=jb["src_target"])

    (jl, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)   # noqa: E731
    args = tcli.parse_args(MTL_ARGS)
    model = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**SMALL),
                                  device="cpu")
    model.load_state_dict(load_jax_params(as_np(jp)))
    loss, metrics = tcli.build_loss(args, model)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ctc_loss"]),
                               float(jm["ctc_loss"]), rtol=1e-5)
    for key in ("ctc_recall", "ctc_precision", "sample_size"):
        np.testing.assert_allclose(float(metrics[key]), float(jm[key]),
                                   rtol=1e-6, err_msg=key)
    ref = load_jax_params(as_np(jgrads))
    for name, p in model.named_parameters():
        scale_name = (name[:-len("bias")] + "weight"
                      if name.endswith("k_proj.bias") else name)
        scale = float(np.abs(ref[scale_name].numpy()).max())
        err = float(np.abs(p.grad.numpy() - ref[name].numpy()).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def _read_events(path):
    """Every Event of a TensorBoard file, its TFRecord CRCs checked."""
    def masked(data):
        c = google_crc32c.value(data)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    events, raw = [], open(path, "rb").read()
    i = 0
    while i < len(raw):
        header = raw[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", raw[i + 8:i + 12])[0] == masked(header)
        data = raw[i + 12:i + 12 + n]
        assert struct.unpack("<I", raw[i + 12 + n:i + 16 + n])[0] == \
            masked(data)
        events.append(event_pb2.Event.FromString(data))
        i += 16 + n
    return events


def test_cli_mtl_freezing_sinks_and_profile(tmp_path, capsys):
    rows = _mtl_rows(str(tmp_path), 16, 2)
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:12]), ("dev", rows[12:])):
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"{s} 1\n" for s in _syms(rows)[4:]))
    small = [f"--override={k}={v}" for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer")]
    base = MTL_ARGS + ["--data", str(tmp_path), "--device", "cpu",
                       "--max-tokens", "800", "--encoder-freezing-updates",
                       "2", *small]
    init = tcli.build_model(tcli.parse_args(base), len(_syms(rows)),
                            device="cpu").state_dict()
    states = {}
    for n in (2, 3):
        save = tmp_path / f"ckpt{n}"
        extra = (["--tensorboard", "--wandb-project", "simulst",
                  "--profile", str(tmp_path / "prof")] if n == 3 else [])
        state = tcli.main(base + ["--max-updates", str(n), "--save-dir",
                                  str(save), *extra])
        assert state.step == n
        states[n] = load_checkpoint(str(save / "checkpoint_last"))[0]
    for key, value in init.items():
        moved = {n: not torch.equal(states[n][key], value) for n in (2, 3)}
        if key.startswith("encoder."):
            assert not moved[2], key
        elif key.startswith("decoder.layers.0.fc1"):
            assert moved[2], key
    assert any(not torch.equal(states[3][k], v) for k, v in init.items()
               if k.startswith("encoder."))
    out = capsys.readouterr().out
    assert "wandb unavailable; skipping sink" in out
    # the profiled update and its trace
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    records = [json.loads(line) for line in
               (tmp_path / "ckpt3" / "train_log.jsonl").read_text()
               .splitlines()]
    assert {"profile_trace": str(tmp_path / "prof" / "trace.json"),
            "update": 3} in records
    # tensorboard: the validation scalars of the jsonl log
    files = glob.glob(str(tmp_path / "ckpt3" / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    events = _read_events(files[0])
    assert events[0].file_version == "brain.Event:2"
    got = {(e.step, v.tag): v.simple_value for e in events[1:]
           for v in e.summary.value}
    want = {(r["valid_update"], k): v for r in records if "valid_update" in r
            for k, v in r.items() if k != "valid_update"}
    assert got.keys() == want.keys() and want
    for k, v in want.items():
        assert got[k] == np.float32(v), k


# ---------------------------------------------------------------------------
# cli/interactive and cli/visualize
# ---------------------------------------------------------------------------

TINY = dict(vocab_size=24, conv_channels=16, embed_dim=16, ffn_dim=32,
            encoder_layers=2, encoder_heads=2, decoder_layers=2,
            decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
            left_context=32, right_context=8, max_memory=2,
            max_target_positions=64, dropout=0.0, attention_dropout=0.0,
            activation_dropout=0.0, no_scale_embedding=True, ctc_layer=True)
MT = dict(vocab_size=24, embed_dim=16, ffn_dim=32, encoder_layers=2,
          decoder_layers=2, num_heads=2, dropout=0.0, attention_dropout=0.0,
          activation_dropout=0.0)
WORDS = [f"▁w{i}" for i in range(20)]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{name: (JAX params, metadata, port checkpoint path)} for one CIF and
    one MT model, the vocabulary file and two tone wavs."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for name, jcls, jcfg_cls, kw in (("cif", jcif.CIFModel, jcif.CIFConfig,
                                      TINY),
                                     ("mt_transformer",
                                      jmt.MTTransformerModel, jmt.MTConfig,
                                      MT)):
        jmodel = jcls(jcfg_cls(**kw))
        jp = jmodel.init(jax.random.PRNGKey(0))
        jp["decoder"]["layer_norm"]["scale"] = jnp.asarray(_rand(
            np.random.RandomState(3), 16, scale=3.0))
        meta = {"model": name, "config": jcfglib.to_dict(jmodel.cfg)}
        path = root / f"{name}_checkpoint"
        save_checkpoint(str(path), load_jax_params(
            jax.tree_util.tree_map(np.asarray, jp)), meta)
        out[name] = (jp, meta, str(path))
    (root / "dict.txt").write_text("".join(f"{w} 1\n" for w in WORDS))
    wavs = []
    for i, secs in enumerate((1.0, 1.3)):
        t = np.arange(int(secs * 16000)) / 16000
        pcm = 0.3 * np.sin(2 * np.pi * (300 + 150 * i) * t) * np.hanning(
            len(t))
        wavs.append(str(root / f"tone{i}.wav"))
        wavfile.write(wavs[-1], 16000, (pcm * 32767).astype(np.int16))
    return root, out, wavs


@pytest.mark.parametrize("task", ["speech", "mt"])
def test_interactive_equals_jax_cli(checkpoints, task, monkeypatch, capsys):
    root, ckpts, wavs = checkpoints
    jp, meta, path = ckpts["cif" if task == "speech" else "mt_transformer"]
    monkeypatch.setattr(jint, "load_checkpoint", lambda p: (jp, meta))
    lines = ("\n".join(wavs) if task == "speech"
             else "▁w1 ▁w5 ▁w3\n▁w2 ▁w2 ▁w9 ▁w4")
    argv = ["--checkpoint", path, "--vocab", str(root / "dict.txt"),
            "--task", task, "--beam", "2", "--max-len", "6"]
    outs = []
    for main, extra in ((jint.main, []), (tint.main, ["--device", "cpu"])):
        monkeypatch.setattr("sys.stdin", io.StringIO(lines + "\n"))
        main(argv + extra)
        outs.append([x for x in capsys.readouterr().out.splitlines()
                     if x.startswith("H-")])
    assert len(outs[1]) == 2 and outs[1] == outs[0]


def test_visualize_equals_jax_cli(checkpoints, tmp_path, monkeypatch, capsys):
    root, ckpts, _ = checkpoints
    jp, meta, path = ckpts["cif"]
    monkeypatch.setattr(jvis, "load_checkpoint", lambda p: (jp, meta))
    rng = np.random.RandomState(5)
    feats = {f"utt{i}": _rand(rng, n, 80) for i, n in enumerate((150, 230))}
    specs = mf.create_feature_zip(feats, str(tmp_path / "feats.zip"))
    mf.save_tsv([{"id": uid, "audio": specs[uid],
                  "n_frames": str(len(f)), "src_text": "w1 w2 w3",
                  "tgt_text": " ".join(f"w{j}" for j in range(2, 9, i + 1)),
                  "speaker": "s"} for i, (uid, f) in enumerate(feats.items())],
                str(tmp_path / "dev_st.tsv"))
    argv = ["--data", str(tmp_path), "--checkpoint", path, "--vocab",
            str(root / "dict.txt"), "--n", "2"]
    jvis.main(argv + ["--out", str(tmp_path / "j")])
    jtext = capsys.readouterr().out
    tvis.main(argv + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert capsys.readouterr().out == jtext and jtext.count("== ") == 2
    for uid in feats:
        j = np.load(str(tmp_path / "j" / f"{uid}.npz"))
        t = np.load(str(tmp_path / "t" / f"{uid}.npz"))
        np.testing.assert_allclose(t["alpha"], j["alpha"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(t["states"], j["states"])
        np.testing.assert_array_equal(t["boundary"], j["boundary"])
        assert t["boundary"].any()
