"""End-to-end smoke of the port: a tone-language corpus -> cli.train ->
cli.average_checkpoints -> cli.stream_eval (fused, batched, scanned).

The port's copy of exp/smoke_synthetic.py.  It fabricates a learnable
micro language (six words, each a pure tone, so the audio determines the
text), writes the reference's data layout (manifests, a feature zip of the
port's fbank, a vocabulary, global CMVN statistics, held-out wavs), then
drives the real CLIs: CIF trained from scratch at embed_dim 64, FFN 256,
2 + 2 layers, bf16 with dropout 0.1, 1000 updates; the last two
checkpoints averaged; the held-out audio streamed with the fused, scanned,
batched evaluator under global CMVN.  It fails unless the streaming BLEU
is above 20 and AL above 0 (the threshold detects collapse, not quality).

    python3 tools/synthetic_smoke.py [WORKDIR] [--mma] [--transducer]
                                     [--device cpu]

--mma adds the wait-k MMA leg (waitk_fixed_pre_decision, k 3, pre-decision
ratio 8; BLEU > 20) and --transducer the transducer's (BLEU > 15).  The
CLIs run on the card unless --device is given.  Prints each leg's scores
and `SMOKE OK` last; exits non-zero when a leg fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import wave

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORDS = ["eins", "zwei", "drei", "vier", "fuenf", "sechs"]
TONES = [440.0, 550.0, 660.0, 770.0, 880.0, 990.0]
SR = 16000
WORD_S = 0.32
VOCAB_FILE = "spm_unigram4096_st.txt"

COMMON_MODEL = [
    "--override", "embed_dim=64", "--override", "ffn_dim=256",
    "--override", "encoder_layers=2", "--override", "decoder_layers=2",
    "--override", "conv_channels=32", "--override", "dropout=0.1",
    "--override", "compute_dtype=bfloat16",
]
# leg -> (train arguments beyond the data and the model widths, the
# stream_eval agent, the least streaming BLEU)
LEGS = {
    "cif": (["--model", "cif", "--loss", "cif", "--max-tokens", "6000"],
            "cif", 20.0),
    "mma": (["--model", "mma", "--loss", "mma", "--max-tokens", "6000",
             "--override", "simul_attn_type=waitk_fixed_pre_decision",
             "--override", "waitk_lagging=3",
             "--override", "fixed_pre_decision_ratio=8"], "mma", 20.0),
    # the RNN-T lattice's memory grows with B S U V: a smaller batch
    "transducer": (["--model", "transducer", "--loss", "rnnt",
                    "--max-tokens", "4000"], "transducer", 15.0),
}


def synth(words, rng):
    parts = []
    for w in words:
        f = TONES[WORDS.index(w)]
        t = np.arange(int(SR * WORD_S)) / SR
        parts.append(np.sin(2 * np.pi * f * t) * 0.3)
    wav = np.concatenate(parts) + rng.randn(
        int(SR * WORD_S) * len(words)) * 0.01
    return wav.astype(np.float32)


def fbank(wav):
    """The port's fbank of one float wav in [-1, 1] (x 2**15), on the CPU."""
    import torch
    from simulst_tpu_torch.ops.fbank import fbank_batch
    return fbank_batch(torch.from_numpy(wav * 2 ** 15)[None])[0].numpy()


def build_corpus(root, n_train=768, n_dev=16):
    """The corpus of exp/smoke_synthetic.build_corpus, row for row (the same
    seeded draws in the same order), with the port's fbank."""
    from simulst_tpu_torch.data import manifest as mf
    rng = np.random.RandomState(0)
    os.makedirs(root, exist_ok=True)
    rows = {"train": [], "dev": []}
    feats = {}
    wav_dir = os.path.join(root, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    dev_wavs, dev_refs = [], []
    for split, n in (("train", n_train), ("dev", n_dev)):
        for i in range(n):
            words = [WORDS[rng.randint(len(WORDS))]
                     for _ in range(rng.randint(2, 6))]
            text = " ".join(words)
            wav = synth(words, rng)
            uid = f"{split}_{i}"
            feats[uid] = fbank(wav)
            rows[split].append(
                {"id": uid, "n_frames": str(feats[uid].shape[0]),
                 "src_text": text, "tgt_text": text, "speaker": "s"})
            if split == "dev":
                path = os.path.join(wav_dir, uid + ".wav")
                with wave.open(path, "w") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(SR)
                    w.writeframes((wav * 32767).astype(np.int16).tobytes())
                dev_wavs.append(os.path.abspath(path))
                dev_refs.append(text)
    allf = np.concatenate([feats[r["id"]] for r in rows["train"]], axis=0)
    np.savez(os.path.join(root, "gcmvn.npz"), mean=allf.mean(0),
             std=allf.std(0) + 1e-8)
    specs = mf.create_feature_zip(feats, os.path.join(root, "fbank80.zip"))
    for split in ("train", "dev"):
        for r in rows[split]:
            r["audio"] = specs[r["id"]]
        mf.save_tsv(rows[split], os.path.join(root, f"{split}_st.tsv"))
    # fairseq-format vocab; the whitespace-fallback tokenizer prefixes each
    # word with the BOW marker
    with open(os.path.join(root, VOCAB_FILE), "w") as f:
        for w in WORDS:
            f.write(f"▁{w} 1\n")
    with open(os.path.join(root, "dev.wav_list"), "w") as f:
        f.write("\n".join(dev_wavs) + "\n")
    with open(os.path.join(root, "dev.de"), "w") as f:
        f.write("\n".join(dev_refs) + "\n")
    return root


def run_module(module, argv):
    """python -m module argv, as a user runs the CLI."""
    print("+", "python -m", module, " ".join(argv), flush=True)
    subprocess.run([sys.executable, "-m", module, *argv], check=True)


def run_leg(work, data, leg, run=run_module, updates=1000, device=None,
            extra=(), check=True):
    """Train, average and stream-evaluate one leg; returns its scores (the
    evaluator's `scores` file), asserting the JAX script's thresholds when
    `check`.  `run(module, argv)` runs a CLI; `extra` adds train
    arguments (tiny depths in the CPU tests)."""
    train_args, agent, min_bleu = LEGS[leg]
    dev_args = ["--device", device] if device else []
    save = os.path.join(work, f"ckpt_{leg}")
    # global CMVN throughout: a streaming agent cannot normalise by the
    # utterance (the future is unknown), so training takes the same global
    # statistics the agent applies
    run("simulst_tpu_torch.cli.train", [
        "--data", data, "--task", "st", *train_args, "--cmvn", "global",
        "--lr", "1e-3", "--warmup-updates", "100", "--max-updates",
        str(updates), "--eval-metric", "bleu", "--save-dir", save,
        *COMMON_MODEL, *extra, *dev_args])
    avg = os.path.join(save, "checkpoint_avg")
    run("simulst_tpu_torch.cli.average_checkpoints",
        ["--dir", save, "--n", "2", "--output", avg])
    out = os.path.join(work, f"simul_out_{leg}")
    run("simulst_tpu_torch.cli.stream_eval", [
        "--source", os.path.join(data, "dev.wav_list"),
        "--target", os.path.join(data, "dev.de"), "--checkpoint", avg,
        "--vocab", os.path.join(data, VOCAB_FILE), "--agent", agent,
        "--fused", "--batch-size", "4", "--scan-sessions", "--global-cmvn",
        os.path.join(data, "gcmvn.npz"), "--output", out, *dev_args])
    with open(os.path.join(out, "scores")) as f:
        scores = json.load(f)
    print(f"{leg} scores:", json.dumps(scores), flush=True)
    if check:
        assert scores["BLEU"] > min_bleu, \
            f"{leg} streaming BLEU {scores['BLEU']} <= {min_bleu}: {scores}"
        assert scores["AL"] > 0.0, f"{leg} streaming AL <= 0: {scores}"
    return scores


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--mma", action="store_true")
    ap.add_argument("--transducer", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the CLIs' device (default: the card)")
    args = ap.parse_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="simulst_smoke_")
    data = build_corpus(os.path.join(work, "data"))
    legs = ["cif"] + ["mma"] * args.mma + ["transducer"] * args.transducer
    for leg in legs:
        run_leg(work, data, leg, device=args.device)
    print("SMOKE OK:", work, flush=True)


if __name__ == "__main__":
    main()
