"""Latency-BLEU report (counterpart of simulst_tpu/cli/latency_bleu.py):
collects the `scores` jsons of cli/stream_eval's result directories and
prints the BLEU vs latency table (AL / AP / DAL and their computation-
aware _CA variants), optionally as a tsv for plotting:

  python -m simulst_tpu_torch.cli.latency_bleu simul_results/*/* \\
      --tsv simul_results/latency_bleu.tsv
"""
from __future__ import annotations

import argparse
import json
import os

COLUMNS = ["BLEU", "AL", "AL_CA", "AP", "AP_CA", "DAL", "DAL_CA"]


def collect(result_dirs):
    """[(dir, scores)] for each directory that holds a `scores` file."""
    rows = []
    for d in result_dirs:
        path = os.path.join(d, "scores")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows.append((d, json.load(f)))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dirs", nargs="+", help="result dirs containing `scores`")
    p.add_argument("--tsv", default=None)
    args = p.parse_args(argv)

    lines = ["\t".join(["system"] + COLUMNS)]
    for name, scores in sorted(collect(args.dirs),
                               key=lambda r: r[1].get("AL", 0.0)):
        # a cell is named by its last two path components (model/split)
        parts = name.rstrip("/").split(os.sep)
        label = "/".join(parts[-2:]) if len(parts) >= 2 else parts[-1]
        lines.append("\t".join(
            [label] + [f"{scores.get(c, 0.0):.2f}" for c in COLUMNS]))
    out = "\n".join(lines)
    print(out)
    if args.tsv:
        with open(args.tsv, "w") as f:
            f.write(out + "\n")
    return out


if __name__ == "__main__":
    main()
