"""Rewrite the feature-zip paths inside tsv manifests after moving the data
(counterpart of simulst_tpu/cli/migrate_data_path.py):

  python -m simulst_tpu_torch.cli.migrate_data_path DATA/*.tsv \\
      --old /old/prefix --new /new/prefix
"""
from __future__ import annotations

import argparse

from simulst_tpu_torch.data.manifest import load_tsv, save_tsv


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("tsvs", nargs="+")
    p.add_argument("--old", required=True, help="path prefix to replace")
    p.add_argument("--new", required=True)
    args = p.parse_args(argv)
    for path in args.tsvs:
        rows = load_tsv(path)
        n = 0
        for r in rows:
            if r["audio"].startswith(args.old):
                r["audio"] = args.new + r["audio"][len(args.old):]
                n += 1
        save_tsv(rows, path)
        print(f"{path}: rewrote {n}/{len(rows)}")


if __name__ == "__main__":
    main()
