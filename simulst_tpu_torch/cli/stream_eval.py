"""Streaming evaluation CLI (counterpart of simulst_tpu/cli/stream_eval.py):
reads a wav_list and a reference file, streams each utterance through the
chosen agent with the built-in READ/WRITE evaluator, and writes `scores`
(json) and `instances.log` as SimulEval does.  The recipe exp/4_simuleval.sh
runs it per checkpoint and split, e.g.

  python -m simulst_tpu_torch.cli.stream_eval --source DATA/dev.wav_list \\
      --target DATA/dev.de --checkpoint checkpoints/cif/checkpoint_avg \\
      --vocab DATA/spm_unigram4096_st.txt --agent cif --cif-beta 1.0 \\
      --global-cmvn DATA/gcmvn.npz --fused --output simul_results/cif/dev

The agent runs on the card unless --device names another.  --agent
transducer, --scan-sessions, --batch-size > 1 and --profile raise: those
are not yet ported (ROADMAP Queue 1 items 9 and 10).
"""
from __future__ import annotations

import argparse
import json
import os

from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.data.wav import read_wav
from simulst_tpu_torch.stream.build import (auto_buffer_sizes, build_agent,
                                            load_vocab)
from simulst_tpu_torch.stream.evaluator import evaluate


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--source", required=True, help="wav_list file")
    p.add_argument("--target", required=True, help="reference text file")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--agent", default="mma",
                   choices=["mma", "waitk", "cif", "transducer"])
    p.add_argument("--model", default=None)
    p.add_argument("--output", default="simul_out")
    p.add_argument("--waitk", type=int, default=None,
                   help="test-time wait-k lagging (waitk_testtime)")
    p.add_argument("--cif-beta", type=float, default=None,
                   help="test-time CIF beta recalibration")
    p.add_argument("--overshoot-weight", type=float, default=1.0)
    p.add_argument("--max-utterances", type=int, default=None)
    p.add_argument("--max-src-frames", type=int, default=None,
                   help="encoder buffer capacity in subsampled frames; by "
                        "default sized to the longest utterance (an "
                        "overflow is flagged 'truncated' in instances.log)")
    p.add_argument("--max-tgt-len", type=int, default=None,
                   help="token and CIF-fire buffer capacity; by default "
                        "sized with --max-src-frames")
    p.add_argument("--global-cmvn", default=None,
                   help="npz with mean / std arrays for online feature "
                        "normalisation")
    p.add_argument("--fused", action="store_true",
                   help="one fused step per chunk (READ and every WRITE)")
    p.add_argument("--scan-sessions", action="store_true",
                   help="not yet ported")
    p.add_argument("--no-ca-pass", action="store_true",
                   help="with --scan-sessions, which is not yet ported")
    p.add_argument("--batch-size", type=int, default=1,
                   help="only 1: batched sessions are not yet ported")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="not yet ported")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    unported = [flag for flag, on in (
        ("--scan-sessions", args.scan_sessions),
        ("--batch-size > 1", args.batch_size > 1),
        ("--profile", args.profile is not None)) if on]
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not yet ported (ROADMAP Queue 1 item 9: "
            "FusedBatchSession, evaluate_batched and the scanned sessions)")

    with open(args.source) as f:
        wav_paths = [line.strip() for line in f if line.strip()]
    with open(args.target) as f:
        refs = [line.strip() for line in f]
    if args.max_utterances:
        wav_paths = wav_paths[: args.max_utterances]
        refs = refs[: args.max_utterances]
    # 16-bit PCM stays int16: OnlineFbank converts it exactly
    utts = [read_wav(path, keep_int16=True)[0] for path in wav_paths]

    vocab = load_vocab(args.vocab)
    overrides = dict(cfglib.parse_override(s) for s in args.override)
    agent = build_agent(args.checkpoint, vocab, agent_type=args.agent,
                        model_name=args.model, overrides=overrides,
                        waitk=args.waitk, cif_beta=args.cif_beta,
                        overshoot_weight=args.overshoot_weight,
                        global_cmvn_path=args.global_cmvn, fused=args.fused,
                        max_src_frames=args.max_src_frames,
                        max_tgt_len=args.max_tgt_len, device=args.device)
    if args.max_src_frames is None or args.max_tgt_len is None:
        src_cap, tgt_cap = auto_buffer_sizes(agent.cfg,
                                             max(len(w) for w in utts))
        agent.acfg.max_src_frames = args.max_src_frames or src_cap
        agent.acfg.max_tgt_len = args.max_tgt_len or tgt_cap
        print(f"auto-sized streaming buffers: max_src_frames="
              f"{agent.acfg.max_src_frames} max_tgt_len="
              f"{agent.acfg.max_tgt_len}")

    os.makedirs(args.output, exist_ok=True)
    scores = evaluate(agent, utts, refs,
                      log_path=os.path.join(args.output, "instances.log"))
    with open(os.path.join(args.output, "scores"), "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()
