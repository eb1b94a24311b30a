"""CIF firing and CTC alignment visualisation (counterpart of
simulst_tpu/cli/visualize.py): for the first --n utterances of a split,
a CIF checkpoint's alpha weights, the CTC best alignment's states
(ops/ctc.best_alignment over the CTC head) and the segment boundaries it
implies, written as <out>/<id>.npz and printed as an ASCII timeline:

  python -m simulst_tpu_torch.cli.visualize --data DATA/en-de \\
      --subset dev --checkpoint SAVE/checkpoint_last \\
      --vocab DATA/spm_unigram4096_st.txt --n 4 --out viz

The model runs on the card unless --device names another.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from simulst_tpu_torch.cli.generate import load_model
from simulst_tpu_torch.data.dataset import (BatcherConfig, SpeechDataset,
                                            make_batches)
from simulst_tpu_torch.data.manifest import load_tsv
from simulst_tpu_torch.data.vocab import PAD, Vocabulary
from simulst_tpu_torch.ops.ctc import best_alignment


def ascii_timeline(alpha, boundaries, width: int = 100) -> str:
    """Two lines: the largest alpha per column as a density character, and
    '|' where a boundary falls."""
    n = len(alpha)
    step = max(n // width, 1)
    line_a, line_b = [], []
    for i in range(0, n, step):
        a = float(np.max(alpha[i:i + step]))
        line_a.append(" .:-=+*#%@"[min(int(a * 10), 9)])
        line_b.append("|" if boundaries[i:i + step].any() else " ")
    return "".join(line_a) + "\n" + "".join(line_b)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--data", required=True)
    p.add_argument("--subset", default="dev")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--out", default="viz")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    args = p.parse_args(argv)

    vocab = (Vocabulary.from_spm(args.vocab) if args.vocab.endswith(".model")
             else Vocabulary.from_txt(args.vocab))
    model = load_model(args.checkpoint, len(vocab), device=args.device)
    device = next(model.parameters()).device

    rows = load_tsv(os.path.join(args.data, f"{args.subset}_st.tsv"))[:args.n]
    ds = SpeechDataset(rows, vocab, BatcherConfig(
        shuffle=False, batch_multiple=1, max_sentences=1,
        frame_buckets=(256, 512, 768, 1024, 1536, 2048, 3072),
        token_buckets=(16, 32, 48, 64, 96, 128)))
    os.makedirs(args.out, exist_ok=True)
    for batch in make_batches(ds):
        b = {k: torch.as_tensor(batch[k], device=device)
             for k in ("feats", "feat_lengths", "prev_tokens", "target")}
        with torch.no_grad():
            _, extra = model(b["feats"], b["feat_lengths"], b["prev_tokens"])
            log_probs = torch.log_softmax(extra["ctc_logits"].float(), dim=-1)
            states = best_alignment(log_probs, extra["encoder_lengths"],
                                    b["target"],
                                    (b["target"] != PAD).sum(-1))
        alpha = extra["alpha"][0].cpu().numpy()
        states = states[0].cpu().numpy()
        seg = states // 2
        boundary = (seg != np.roll(seg, -1)) & (states % 2 != 0)
        uid = batch["ids"][0]
        np.savez(os.path.join(args.out, uid + ".npz"), alpha=alpha,
                 states=states, boundary=boundary)
        print(f"== {uid}")
        print(ascii_timeline(alpha, boundary))


if __name__ == "__main__":
    main()
