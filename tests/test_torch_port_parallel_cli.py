"""cli/train and cli/generate under torchrun on the CPU (two ranks over
gloo) against one process, and the kernel build's lock when several
processes build at once.  The manifest: 16 utterances of 48-80 seeded
random fbank frames with short transcripts (simulst_tpu_torch/multichip.py
synthetic_manifest); the model: 2 + 2 layers, width 64, no dropout, no
SpecAugment, so that the ranks' folded dropout seeds draw nothing.
Tolerances: each update's logged loss and gradient norm rtol 1e-5
against one process (they read the rows each rank trained on and the
summed gradients); the checkpoints within twice the two updates' summed
learning rate, a sanity bound only (Adam moves every entry by at most
the learning rate, whatever its gradient, so it does not test the
gradient); the generated lines and the WER equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist runs several workers: one intra-op thread each

from simulst_tpu_torch import multichip as mc  # noqa: E402
from simulst_tpu_torch.ops import _build  # noqa: E402

SMALL = dict(conv_channels=16, embed_dim=64, ffn_dim=128, encoder_layers=2,
             encoder_heads=2, decoder_layers=2, decoder_heads=2,
             decoder_ffn_dim=128, segment_length=16, left_context=32,
             right_context=8, max_memory=2, max_target_positions=64,
             dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("manifest")
    rows, symbols = mc.synthetic_manifest(str(root), 16,
                                          lambda i: 48 + 16 * (i % 3))
    return dict(eval_rows=rows, symbols=symbols)


ASR_ARGS = ["--task", "asr", "--model", "s2t_emformer", "--loss",
            "joint_ctc", "--override", "ctc_layer=true", "--no-specaugment",
            "--cmvn", "none", "--max-updates", "2", "--max-tokens", "4000",
            "--log-interval", "1"]


def _cli_tree(root, setup):
    rows = setup["eval_rows"]
    header = "id\taudio\tn_frames\tsrc_text\ttgt_text\tspeaker"
    for split, part in (("train", rows), ("dev", rows[:8])):
        (root / f"{split}_st.tsv").write_text("\n".join(
            [header] + ["\t".join([r["id"], r["audio"], r["n_frames"],
                                   r["tgt_text"], r["tgt_text"], "s"])
                        for r in part]) + "\n")
    (root / "spm_unigram.txt").write_text(
        "".join(f"{s} 1\n" for s in setup["symbols"][4:]))
    return [f"--override={k}={v}" for k, v in SMALL.items()]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, argv, ranks=1):
    """python -m module argv, under torchrun --standalone with `ranks`
    processes where ranks > 1."""
    launcher = ([] if ranks == 1 else
                ["-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(ranks)])
    return subprocess.run([sys.executable, *launcher, "-m", module, *argv],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="1"),
                          cwd=ROOT)


def test_cli_under_torchrun_matches_one_process(tmp_path, setup):
    """cli/train under torchrun --nproc-per-node 2 --device cpu: two
    updates; rank 0 alone writes the log (as many records as the one
    process's) and checkpoint_last; each update's loss and gradient norm
    match the one process's (rtol 1e-5), and the checkpoint's parameters
    are within twice the summed learning rate of its (a sanity bound,
    not a test of the gradient); --pack with two data ranks raises;
    cli/generate under torchrun writes the one process's lines and
    WER."""
    from simulst_tpu_torch.train.checkpoint import load_checkpoint
    from simulst_tpu_torch.train.optim import (OptimConfig,
                                               inverse_sqrt_schedule)
    overrides = _cli_tree(tmp_path, setup)
    common = ASR_ARGS + ["--data", str(tmp_path), "--device", "cpu",
                         *overrides]
    train = "simulst_tpu_torch.cli.train"
    one = _run(train, common + ["--save-dir", str(tmp_path / "one")])
    assert one.returncode == 0, one.stderr[-3000:]
    two = _run(train, common + ["--save-dir", str(tmp_path / "two")], 2)
    assert two.returncode == 0, two.stderr[-3000:]
    assert "data-parallel: rank 1 of 2 on cpu over gloo" in two.stdout
    logs = [(tmp_path / name / "train_log.jsonl").read_text().splitlines()
            for name in ("one", "two")]
    assert len(logs[1]) == len(logs[0]) and any(
        '"valid_update": 2' in line for line in logs[1]), logs
    updates = [[r for r in map(json.loads, log) if "gnorm" in r]
               for log in logs]
    assert [r["update"] for r in updates[0]] == [1, 2]
    assert [r["update"] for r in updates[1]] == [1, 2]
    for got, want in zip(updates[1], updates[0]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=1e-5)
    a, _ = load_checkpoint(str(tmp_path / "one" / "checkpoint_last"))
    b, meta = load_checkpoint(str(tmp_path / "two" / "checkpoint_last"))
    assert meta["step"] == 2
    sched = inverse_sqrt_schedule(OptimConfig(warmup_updates=4000))
    tol = 2 * (sched(0) + sched(1))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)
    packed = _run(train, common + ["--pack", "--save-dir",
                                   str(tmp_path / "pack")], 2)
    assert packed.returncode != 0
    assert "--pack with data parallelism" in packed.stderr
    # cli/generate: each rank decodes its shard of the subset; rank 0
    # writes every utterance's lines and the score of the whole subset
    gen = ["--data", str(tmp_path), "--gen-subset", "train", "--checkpoint",
           str(tmp_path / "two" / "checkpoint_last"), "--task", "asr",
           "--beam", "1", "--max-len", "8", "--scoring", "wer",
           "--device", "cpu"]
    outs = []
    for ranks in (1, 2):
        out = tmp_path / f"gen{ranks}.txt"
        res = _run("simulst_tpu_torch.cli.generate",
                   gen + ["--output", str(out)], ranks)
        assert res.returncode == 0, res.stderr[-3000:]
        outs.append(out.read_text().splitlines())
    assert outs[0][-1] == outs[1][-1] and outs[0][-1].startswith("SCORE")
    assert sorted(outs[0]) == sorted(outs[1])


def test_build_is_one_compile_for_concurrent_callers(tmp_path):
    """Two processes build the same stub source at once with a stand-in
    nvcc that logs each call: one compiles and links, the other waits and
    returns the same library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "stub.cu").write_text("// stub\n")
    bindir = tmp_path / "bin"
    bindir.mkdir()
    calls = tmp_path / "calls.log"
    fake = bindir / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        open({str(calls)!r}, "a").write(" ".join(sys.argv[1:]) + "\\n")
        time.sleep(0.5)
        out = sys.argv[sys.argv.index("-o") + 1]
        open(out, "w").write("built")
        """))
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}")
    code = ("from pathlib import Path; from simulst_tpu_torch.ops import "
            f"_build; print(_build.build(Path({str(csrc)!r}), "
            f"Path({str(tmp_path / 'out')!r})))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              cwd=root, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1] == str(_build.library_path(
        csrc, tmp_path / "out"))
    lines = calls.read_text().splitlines()
    assert len(lines) == 2, lines               # one compile, one link
    assert sum("-shared" in line for line in lines) == 1
