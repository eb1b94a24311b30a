"""Best-N checkpoint averaging (counterpart of
simulst_tpu/cli/average_checkpoints.py), the recipe's step after training:

  python -m simulst_tpu_torch.cli.average_checkpoints --dir checkpoints/mma \\
      --n 5 --output checkpoints/mma/checkpoint_avg

The best N `checkpoint.best_<metric>_<value>` files of --dir (bleu
maximises; loss, wer and latency minimise, unless --maximize / --minimize
says otherwise) are averaged parameter by parameter in fp32 and written
with the metadata of the best one.
"""
from __future__ import annotations

import argparse

from simulst_tpu_torch.train.checkpoint import (average_params,
                                                find_best_checkpoints,
                                                load_checkpoint,
                                                save_checkpoint)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--maximize", action="store_true", default=None,
                   help="higher metric is better (default: inferred from "
                        "the checkpoint metric name; bleu maximizes)")
    p.add_argument("--minimize", dest="maximize", action="store_false",
                   help="lower metric is better")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    paths = find_best_checkpoints(args.dir, args.n, args.maximize)
    if not paths:
        raise SystemExit(f"no checkpoint.best_* entries under {args.dir}")
    print("averaging:", *paths, sep="\n  ")
    states, meta = [], None
    for path in paths:
        state, m = load_checkpoint(path)
        states.append(state)
        meta = meta or m
    save_checkpoint(args.output, average_params(states), metadata=meta)
    print("saved:", args.output)
    return paths


if __name__ == "__main__":
    main()
