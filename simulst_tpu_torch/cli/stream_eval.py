"""Streaming evaluation CLI (counterpart of simulst_tpu/cli/stream_eval.py):
reads a wav_list and a reference file, streams each utterance through the
chosen agent with the built-in READ/WRITE evaluator, and writes `scores`
(json) and `instances.log` as SimulEval does.  The recipe exp/4_simuleval.sh
runs it per checkpoint and split, e.g.

  python -m simulst_tpu_torch.cli.stream_eval --source DATA/dev.wav_list \\
      --target DATA/dev.de --checkpoint checkpoints/cif/checkpoint_avg \\
      --vocab DATA/spm_unigram4096_st.txt --agent cif --cif-beta 1.0 \\
      --global-cmvn DATA/gcmvn.npz --fused --output simul_results/cif/dev

With --fused, --batch-size B streams B utterances of one chunk-count
bucket lock-step through one step per chunk (exp/4_simuleval.sh's EXTRA
"--fused --batch-size 8"), and --scan-sessions runs each bucket's whole
session in one call, then a chunk-by-chunk pass for the _CA metrics
(skipped with --no-ca-pass).  --profile DIR writes a torch.profiler
trace of one streaming session.  --agent transducer streams a
transducer checkpoint (exp/6_transducer.sh's last command).  The agent
runs on the card unless --device names another.
"""
from __future__ import annotations

import argparse
import json
import os

from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.data.wav import read_wav
from simulst_tpu_torch.stream.build import (auto_buffer_sizes, build_agent,
                                            load_vocab)
from simulst_tpu_torch.stream.evaluator import (evaluate, evaluate_batched,
                                                merge_honest_ca, run_session)


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
                   help="run each chunk-count bucket's whole session in one "
                        "call (requires --fused); the _CA metrics come from "
                        "a chunk-by-chunk pass unless --no-ca-pass")
    p.add_argument("--no-ca-pass", action="store_true",
                   help="with --scan-sessions: skip the chunk-by-chunk "
                        "pass; _CA is then the whole session's wall clock, "
                        "an upper bound (stamped mode 'scan')")
    p.add_argument("--batch-size", type=int, default=1,
                   help="> 1 streams B utterances per step (requires "
                        "--fused; lock-step within a chunk-count bucket)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of one streaming "
                        "session of the first utterance")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    batched = args.scan_sessions or args.batch_size > 1
    if batched and not args.fused:
        raise SystemExit("--scan-sessions / --batch-size > 1 require --fused")

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

    if args.profile:
        profile(agent, utts[0], args.profile)

    os.makedirs(args.output, exist_ok=True)
    log = os.path.join(args.output, "instances.log")
    if batched:
        # --scan-sessions at the default --batch-size 1 runs the batched
        # evaluator at B = 1
        scores = evaluate_batched(agent, utts, refs,
                                  batch_size=args.batch_size, log_path=log,
                                  scan=args.scan_sessions)
        if args.scan_sessions and not args.no_ca_pass:
            # a whole-session call cannot time its chunks: the _CA metrics
            # come from a chunk-by-chunk pass of the same batches
            ca = evaluate_batched(
                agent, utts, refs, batch_size=args.batch_size,
                log_path=os.path.join(args.output, "instances_ca.log"))
            scores = merge_honest_ca(scores, ca)
    else:
        scores = evaluate(agent, utts, refs, log_path=log)
    with open(os.path.join(args.output, "scores"), "w") as f:
        json.dump(scores, f, indent=2)
    print(json.dumps(scores, indent=2))
    return scores


def profile(agent, wav, out_dir: str):
    """A torch.profiler trace (Chrome JSON) of one streaming session of
    `wav`, after one untraced session to warm up."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    run_session(agent, wav)
    activities = [ProfilerActivity.CPU]
    if agent.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        run_session(agent, wav)
        if agent.device.type == "cuda":
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")
    return path


if __name__ == "__main__":
    main()
