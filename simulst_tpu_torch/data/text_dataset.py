"""Parallel text dataset + batcher for MT training, the seq-KD teacher
(a copy of simulst_tpu/data/text_dataset.py).

Reads a tsv manifest's (src_text, tgt_text) columns and batches with the
same bucketed shapes as the JAX package, so a batch's shapes come from a
small fixed set.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from simulst_tpu_torch.data.dataset import (BatcherConfig, _bucket,
                                            move_eos_to_begin)
from simulst_tpu_torch.data.vocab import EOS, PAD, Vocabulary


class TextDataset:
    def __init__(self, pairs: List[Dict[str, str]], src_vocab: Vocabulary,
                 tgt_vocab: Optional[Vocabulary] = None,
                 src_field: str = "src_text", tgt_field: str = "tgt_text"):
        self.pairs = pairs
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab or src_vocab
        self.src_field = src_field
        self.tgt_field = tgt_field

    def __len__(self):
        return len(self.pairs)

    def example(self, i: int):
        r = self.pairs[i]
        src = self.src_vocab.encode(r[self.src_field], append_eos=True)
        tgt = self.tgt_vocab.encode(r[self.tgt_field], append_eos=True)
        return np.asarray(src, np.int32), np.asarray(tgt, np.int32)


def make_text_batches(ds: TextDataset, cfg: BatcherConfig, epoch: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    lens = [len(ds.pairs[i][ds.src_field].split()) + 1
            for i in range(len(ds))]
    order = np.argsort(lens)
    if cfg.shuffle:
        rng = np.random.RandomState(cfg.seed + epoch)
        blocks = [order[i:i + 256] for i in range(0, len(order), 256)]
        rng.shuffle(blocks)
        order = np.concatenate(blocks) if blocks else order

    batch, mx = [], 0
    for i in order:
        mx2 = max(mx, lens[i])
        if batch and (mx2 * (len(batch) + 1) > cfg.max_tokens or
                      (cfg.max_sentences and len(batch) >= cfg.max_sentences)):
            yield _collate_text(ds, batch, cfg)
            batch, mx = [], 0
        batch.append(i)
        mx = max(mx, lens[i])
    if batch:
        yield _collate_text(ds, batch, cfg)


def _collate_text(ds: TextDataset, idxs, cfg: BatcherConfig):
    examples = [ds.example(i) for i in idxs]
    sb = _bucket(max(len(s) for s, _ in examples), cfg.token_buckets)
    tb = _bucket(max(len(t) for _, t in examples), cfg.token_buckets)
    bsz = len(examples)
    b_pad = -(-bsz // cfg.batch_multiple) * cfg.batch_multiple
    src = np.full((b_pad, sb), PAD, np.int32)
    tgt = np.full((b_pad, tb), PAD, np.int32)
    prev = np.full((b_pad, tb), PAD, np.int32)
    for j, (s, t) in enumerate(examples):
        s = s[:sb].copy(); s[-1] = EOS
        t = t[:tb].copy(); t[-1] = EOS
        src[j, :len(s)] = s
        tgt[j, :len(t)] = t
        prev[j, :len(t)] = np.asarray(move_eos_to_begin(list(t)), np.int32)
    return {"src_tokens": src, "target": tgt, "prev_tokens": prev,
            "n_real": bsz, "indices": list(map(int, idxs))}
