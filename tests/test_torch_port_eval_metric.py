"""Inline BLEU / WER validation and metric-driven best checkpoints of
simulst_tpu_torch vs the JAX package, on the CPU: `cli/train`'s
`build_valid_fn` (the validation loss, then greedy decoding through
`decode_batch` and corpus BLEU or WER) equal to JAX's on one tiny batch;
`Trainer._maybe_save_best` keeping `checkpoint.best_bleu_*` by maximum and
`best_wer_*` / `best_loss_*` by minimum, with the same files, best value
and patience count as the JAX loop's after every validation; and the CLI
end to end: `--eval-metric wer` writes `checkpoint.best_wer_*`, while
`--task mt --eval-metric bleu` writes no best checkpoint and never counts
patience, as the JAX package does (it decodes no MT batch, so the metric
is missing; ROADMAP Queue 3).

Small s2t_emformer: 2 + 2 layers, width 16, 2 heads, FFN 32, vocab 24,
the CTC head; JAX init bridged to the port, the decoder's final layer norm
scale drawn at random (N(0, 9)) so that greedy tokens vary; fp32 with
jax_default_matmul_precision float32 (tests/conftest.py); no dropout.
Tolerances: the validation loss rtol 1e-5; BLEU and WER exactly (the same
hypotheses; on the port's side every greedy step's top-2 logit gap is
above 1e-2, far beyond its 1e-4 stack tolerance).
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each
import jax.numpy as jnp  # noqa: E402

from simulst_tpu.cli import train as jcli  # noqa: E402
from simulst_tpu.data.vocab import Vocabulary as JVocab  # noqa: E402
from simulst_tpu.models import s2t_emformer as js2t  # noqa: E402
from simulst_tpu.train import loop as jloop  # noqa: E402
from simulst_tpu_torch.cli import train as tcli  # noqa: E402
from simulst_tpu_torch.compat.jax_bridge import load_jax_params  # noqa: E402
from simulst_tpu_torch.data import synthetic as tsyn  # noqa: E402
from simulst_tpu_torch.data.vocab import Vocabulary as TVocab  # noqa: E402
from simulst_tpu_torch.models import s2t_emformer as ts2t  # noqa: E402
from simulst_tpu_torch.train import loop as tloop  # noqa: E402

SMALL = dict(vocab_size=24, input_feat=8, conv_channels=16, embed_dim=16,
             ffn_dim=32, encoder_layers=2, encoder_heads=2, decoder_layers=2,
             decoder_heads=2, decoder_ffn_dim=32, segment_length=16,
             left_context=32, right_context=8, max_memory=2,
             max_target_positions=64, ctc_layer=True, dropout=0.0,
             attention_dropout=0.0, activation_dropout=0.0)
SYMBOLS = ["<s>", "<pad>", "</s>", "<unk>"] + [f"▁w{i}" for i in range(20)]


def _batch(seed):
    """Two utterances of 64 and 48 frames, targets of 5 and 3 words with
    EOS, the batcher's keys.  The first target starts with the three words
    the model writes there (16 18 16), so that BLEU is not 0."""
    rng = np.random.RandomState(seed)
    target = np.ones((2, 6), np.int64)
    prev = np.ones((2, 6), np.int64)
    for j, n in enumerate((5, 3)):
        target[j, :n + 1] = np.append(rng.randint(4, 24, n), 2)
        prev[j, :n + 1] = np.append(2, target[j, :n])
    target[0, :3] = prev[0, 1:4] = (16, 18, 16)
    return {"feats": rng.randn(2, 64, 8).astype(np.float32),
            "feat_lengths": np.array([64, 48]), "target": target,
            "prev_tokens": prev, "ids": ["a", "b"], "n_real": 2,
            "indices": [0, 1]}


@pytest.mark.parametrize("metric,task", [("bleu", "st"), ("wer", "asr")])
def test_valid_fn_matches_jax(metric, task):
    jmodel = js2t.S2TEmformerModel(js2t.S2TEmformerConfig(**SMALL))
    jp = jmodel.init(jax.random.PRNGKey(0))
    jp["decoder"]["layer_norm"]["scale"] = jnp.asarray(
        np.random.RandomState(3).randn(16).astype(np.float32) * 3.0)
    tmodel = ts2t.S2TEmformerModel(ts2t.S2TEmformerConfig(**SMALL),
                                   device="cpu")
    tmodel.load_state_dict(load_jax_params(jax.tree_util.tree_map(np.asarray,
                                                                 jp)))
    args = SimpleNamespace(task=task, eval_metric=metric, eval_beam=1,
                           eval_max_len=8, loss="joint_ctc",
                           loss_overrides={}, specaugment=False)
    want = jcli.build_valid_fn(args, jmodel, JVocab(SYMBOLS), None,
                               lambda: iter([_batch(1)]),
                               jcli.build_loss(args, jmodel))(jp)
    with torch.no_grad():
        got = tcli.build_valid_fn(args, TVocab(SYMBOLS),
                                  tcli.build_loss(args, tmodel),
                                  lambda: iter([_batch(1)]), "cpu")(tmodel)
    assert sorted(got) == sorted(want) == sorted(["loss", metric])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got[metric] == want[metric] > 0


def _trainer(cls, tmp, metric):
    """A stand-in for a Trainer of the JAX or the port loop (the state it
    checkpoints and the fields _maybe_save_best reads)."""
    cfg = cls.__module__.startswith("simulst_tpu_torch")
    loop_cfg = (tloop if cfg else jloop).LoopConfig(
        keep_best=2, save_dir=str(tmp), best_metric=metric,
        maximize_metric=metric == "bleu")
    state = SimpleNamespace(step=3, params={"w": np.zeros(2, np.float32)},
                            model=torch.nn.Linear(2, 1))
    return SimpleNamespace(loop_cfg=loop_cfg, best=None, bad_epochs=0,
                           metadata={}, state=state)


@pytest.mark.parametrize("metric", ["bleu", "wer", "loss"])
def test_best_checkpoints_follow_the_metric_as_jax(metric, tmp_path,
                                                   monkeypatch):
    """Five validations with keep_best 2 (for BLEU and WER one without the
    metric, which saves nothing; for the loss that one's loss is 2.0):
    after each, the same best_* files, best value and patience count."""
    monkeypatch.setattr(jloop, "save_checkpoint",
                        lambda path, *a, **k: os.makedirs(path))
    values = [12.5, 30.25, None, 20.0, 8.0]
    sides = {}
    for name, cls in (("jax", jloop.Trainer), ("port", tloop.Trainer)):
        (tmp_path / name).mkdir()
        sides[name] = (cls, _trainer(cls, tmp_path / name, metric))
    for i, v in enumerate(values):
        metrics = {"loss": 3.0 - 0.5 * i}
        if v is not None:
            metrics[metric] = v
        for name, (cls, fake) in sides.items():
            cls._maybe_save_best(fake, dict(metrics), count_patience=True)
        (_, jax_side), (_, port_side) = sides["jax"], sides["port"]
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))
        assert (port_side.best, port_side.bad_epochs) == \
            (jax_side.best, jax_side.bad_epochs)
    kept = sorted(os.listdir(tmp_path / "port"))
    assert kept == {"bleu": ["checkpoint.best_bleu_20.0000",
                             "checkpoint.best_bleu_30.2500"],
                    "wer": ["checkpoint.best_wer_12.5000",
                            "checkpoint.best_wer_8.0000"],
                    "loss": ["checkpoint.best_loss_2.0000",
                             "checkpoint.best_loss_8.0000"]}[metric]


def _speech_manifest(root):
    rows = tsyn.mustc_like_rows(12, seed=2, tmpdir=str(root), feat_dim=8)
    for r in rows:   # 1-3 s, so the CPU steps stay short
        r["n_frames"] = str(min(int(r["n_frames"]), 300))
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows[:8]), ("dev", rows[8:])):
        (root / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join(r[c] for c in header.split("\t"))
                        for r in part]) + "\n")
    (root / "spm_unigram.txt").write_text(
        "".join(f"▁{c * 3} 1\n" for c in "abcdefghij"))


def test_cli_eval_metric_wer_writes_best_wer_checkpoints(tmp_path):
    """--task asr --eval-metric wer: parsed, validated with a WER in the
    log, the best checkpoint named by it."""
    args = tcli.parse_args(["--task", "asr", "--model", "s2t_emformer",
                            "--loss", "joint_ctc", "--eval-metric", "wer"])
    assert (args.eval_metric, args.eval_beam, args.eval_max_len,
            args.best_metric) == ("wer", 1, 96, None)
    _speech_manifest(tmp_path)
    save = tmp_path / "ckpt"
    small = [f"--override={k}={v}" for k, v in SMALL.items()
             if k not in ("vocab_size", "ctc_layer", "dropout",
                          "attention_dropout", "activation_dropout")]
    tcli.main(["--task", "asr", "--model", "s2t_emformer", "--loss",
               "joint_ctc", "--override", "ctc_layer=true", "--eval-metric",
               "wer", "--eval-max-len", "6", "--data", str(tmp_path),
               "--device", "cpu", "--max-updates", "1", "--max-tokens",
               "1200", "--save-dir", str(save), *small])
    log = (save / "train_log.jsonl").read_text()
    assert '"wer"' in log
    best = [p.name for p in save.iterdir()
            if p.name.startswith("checkpoint.best_")]
    assert len(best) == 1 and best[0].startswith("checkpoint.best_wer_")


def test_cli_mt_eval_metric_bleu_keeps_no_best_checkpoint(tmp_path):
    """--task mt --eval-metric bleu --patience 1: the JAX package never
    decodes for MT, so no validation has a BLEU; no best checkpoint is
    written and three epochs run without an early stop."""
    words = [f"w{i}" for i in range(20)]
    (tmp_path / "spm_unigram.txt").write_text(
        "".join(f"▁{w} 1\n" for w in words))
    rng = np.random.RandomState(0)
    for split, n in (("train", 6), ("dev", 4)):
        rows = ["id\tsrc_text\ttgt_text"] + [
            f"{split}{i}\t{' '.join(rng.choice(words, rng.randint(2, 6)))}\t"
            f"{' '.join(rng.choice(words, rng.randint(2, 6)))}"
            for i in range(n)]
        (tmp_path / f"{split}_st.tsv").write_text("\n".join(rows) + "\n")
    save = tmp_path / "ckpt"
    state = tcli.main([
        "--data", str(tmp_path), "--task", "mt", "--model", "mt_transformer",
        "--loss", "ce", "--device", "cpu", "--max-updates", "3",
        "--max-tokens", "64", "--save-dir", str(save), "--eval-metric",
        "bleu", "--patience", "1", "--override=embed_dim=16",
        "--override=ffn_dim=32", "--override=encoder_layers=1",
        "--override=decoder_layers=1", "--override=num_heads=2"])
    assert state.step == 3
    log = (save / "train_log.jsonl").read_text()
    assert '"valid_update"' in log and '"bleu"' not in log
    assert "early_stop" not in log
    assert not [p for p in save.iterdir()
                if p.name.startswith("checkpoint.best_")]
