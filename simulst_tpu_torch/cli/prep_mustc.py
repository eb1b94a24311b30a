"""MuST-C preparation CLI (counterpart of simulst_tpu/cli/prep_mustc.py):
fbank features (on the card unless --device names another), zips and
manifests per split, then from the train split the SPM vocabulary, the
data config and gcmvn.npz:

  python -m simulst_tpu_torch.cli.prep_mustc --data-root MUSTC \\
      --out-dir DATA/en-de --tgt-lang de --vocab-size 4096 --task st

--long-seconds 20 40 60 also builds tst-COMMON's long-utterance
robustness splits (wavs, wav list and references).
"""
from __future__ import annotations

import argparse

from simulst_tpu_torch.data import mustc


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data-root", required=True,
                   help="MuST-C root (en-XX dirs)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--tgt-lang", default="de")
    p.add_argument("--vocab-size", type=int, default=4096)
    p.add_argument("--splits", nargs="+", default=mustc.SPLITS)
    p.add_argument("--task", default="st", choices=["st", "asr"])
    p.add_argument("--long-seconds", nargs="*", type=float, default=[],
                   help="also build N-second long-utterance robustness "
                        "splits from tst-COMMON (the reference: 20 40 60)")
    p.add_argument("--device", default=None,
                   help="torch device of the fbank (default: the card)")
    args = p.parse_args(argv)

    train_rows = None
    for split in args.splits:
        rows = mustc.process_split(args.data_root, split, args.out_dir,
                                   tgt_lang=args.tgt_lang,
                                   device=args.device)
        if split == "train":
            train_rows = rows
        print(f"{split}: {len(rows)} utterances")
    for secs in args.long_seconds:
        n = mustc.process_long_split(args.data_root, "tst-COMMON",
                                     args.out_dir, secs,
                                     tgt_lang=args.tgt_lang)
        print(f"tst-COMMON-{int(secs)}s: {n} long utterances")
    if train_rows:
        fields = ("src_text",) if args.task == "asr" else ("tgt_text",)
        mustc.build_vocab(train_rows, args.out_dir, args.vocab_size, fields)
        mustc.write_config(args.out_dir, args.vocab_size)
        mustc.write_gcmvn(args.out_dir, train_rows)


if __name__ == "__main__":
    main()
