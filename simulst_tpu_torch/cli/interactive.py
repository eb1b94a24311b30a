"""Interactive decoding (counterpart of simulst_tpu/cli/interactive.py):
reads wav paths (--task speech) or raw text (--task mt) from stdin, one
per line, decodes each with beam search and prints `H-<i>\\t<text>`:

  ls tst/*.wav | python -m simulst_tpu_torch.cli.interactive \\
      --checkpoint SAVE/checkpoint_avg --vocab DATA/spm_unigram4096_st.txt

The model is built from the checkpoint's metadata (--model and --override
change it) and runs on the card unless --device names another; the fbank
and its utterance CMVN run there too.
"""
from __future__ import annotations

import argparse
import sys

import torch

from simulst_tpu_torch import config as cfglib
from simulst_tpu_torch.cli.generate import (decode_batch, decode_batch_mt,
                                            load_model)
from simulst_tpu_torch.data.vocab import EOS, Vocabulary
from simulst_tpu_torch.data.wav import read_wav
from simulst_tpu_torch.decode.beam import BeamConfig
from simulst_tpu_torch.ops.fbank import fbank_batch, utterance_cmvn


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vocab", required=True)
    p.add_argument("--model", default=None)
    p.add_argument("--beam", type=int, default=5)
    p.add_argument("--max-len", type=int, default=200)
    p.add_argument("--cmvn", default="utterance",
                   choices=["utterance", "none"])
    p.add_argument("--task", default="speech", choices=["speech", "mt"],
                   help="speech: stdin lines are wav paths; mt: raw text")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda)")
    args = p.parse_args(argv)

    vocab = (Vocabulary.from_spm(args.vocab) if args.vocab.endswith(".model")
             else Vocabulary.from_txt(args.vocab))
    overrides = dict(cfglib.parse_override(s) for s in args.override)
    model = load_model(args.checkpoint, len(vocab), args.model, overrides,
                       device=args.device)
    device = next(model.parameters()).device
    beam_cfg = BeamConfig(beam_size=args.beam, max_len=args.max_len)

    with torch.no_grad():
        for i, line in enumerate(sys.stdin):
            line = line.strip()
            if not line:
                continue
            if args.task == "mt":
                src = torch.tensor([vocab.encode(line)], device=device)
                tokens, lengths = decode_batch_mt(model, {"src_tokens": src},
                                                  beam_cfg)
            else:
                wav, _ = read_wav(line)
                feats = fbank_batch(torch.from_numpy(wav * 2 ** 15)[None]
                                    .to(device))
                if args.cmvn == "utterance":
                    feats = utterance_cmvn(feats)
                batch = {"feats": feats, "feat_lengths": torch.tensor(
                    [feats.shape[1]], device=device)}
                tokens, lengths = decode_batch(model, batch, beam_cfg)
            ids = [int(t) for t in tokens[0][:int(lengths[0])].tolist()
                   if t != EOS]
            print(f"H-{i}\t{vocab.decode_ids(ids)}", flush=True)


if __name__ == "__main__":
    main()
