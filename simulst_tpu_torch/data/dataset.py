"""Speech dataset and the bucketing batcher (a copy of
simulst_tpu/data/dataset.py, numpy path).

Batch shapes are quantised to a fixed ladder of (frame, token) buckets.
Every frame bucket is a multiple of 64 raw frames, one Emformer segment
after the stride-4 subsampler, so the grouped-attention kernel's path
always applies.  Batches are cut on the fully sorted order (frames, then
target length within a frame bucket) at `batch_multiple` boundaries, the
remainder carried into the next batch, and the batch list is shuffled per
epoch.  A batch whose features are all zip members (`zip:offset:length`)
loads in one threaded C++ call with the CMVN in C++ (data/native.py); a
plain .npy path loads with numpy.  With `mtl_src` each batch also carries
`src_target`, the transcripts' token ids, for a CTC on transcripts beside
the CE on translations (cli/train --mtl).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from simulst_tpu_torch.data import native
from simulst_tpu_torch.data.features import global_cmvn, utterance_cmvn
from simulst_tpu_torch.data.manifest import read_feature
from simulst_tpu_torch.data.vocab import EOS, PAD, Vocabulary


@dataclasses.dataclass
class BatcherConfig:
    max_tokens: int = 40000          # frames (speech) / tokens (text)
    max_sentences: Optional[int] = None
    frame_buckets: Sequence[int] = tuple(range(64, 2048 + 1, 64)) + \
        (2560, 3072)
    token_buckets: Sequence[int] = tuple(range(8, 128 + 1, 8))
    cmvn: str = "utterance"          # "utterance" | "global" | "none"
    shuffle: bool = True
    seed: int = 1
    batch_multiple: int = 8          # pad batch size to a multiple
    tgt_sort: bool = True            # sort by target length within a bucket


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def move_eos_to_begin(tokens: List[int]) -> List[int]:
    """prev_output_tokens construction (fairseq convention)."""
    assert tokens[-1] == EOS
    return [EOS] + tokens[:-1]


class SpeechDataset:
    """Manifest rows, their vocabulary and the field the targets come
    from."""

    def __init__(self, rows: List[Dict[str, str]], vocab: Vocabulary,
                 cfg: BatcherConfig, target_field: str = "tgt_text",
                 global_stats=None, mtl_src: bool = False):
        self.rows = rows
        self.vocab = vocab
        self.cfg = cfg
        self.target_field = target_field
        self.global_stats = global_stats
        self.mtl_src = mtl_src
        self._feat_dim = None

    def __len__(self):
        return len(self.rows)

    def feat_dim(self) -> int:
        if self._feat_dim is None:
            self._feat_dim = read_feature(self.rows[0]["audio"]).shape[1]
        return self._feat_dim


def make_batches(dataset: SpeechDataset, cfg: Optional[BatcherConfig] = None,
                 epoch: int = 0, num_shards: int = 1, shard_id: int = 0
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Padded batches with bucketed shapes: feats (B, Tb, F), feat_lengths,
    target (B, Lb) with EOS, prev_tokens, ids, n_real.  Shard `shard_id`
    of `num_shards` takes every num_shards-th utterance of the length
    order (the reference's distributed eval sharding,
    eval/generate.py:151-152); cli/train reads one shard per node of a
    torchrun run, as the JAX package reads one per process."""
    cfg = cfg or dataset.cfg
    order = np.argsort([int(r["n_frames"]) for r in dataset.rows])
    if num_shards > 1:
        order = order[shard_id::num_shards]
    if cfg.tgt_sort and len(order):
        # character length stands in for the token count; lexsort is
        # stable, so equal lengths keep the frame order
        tlen = np.asarray([len(dataset.rows[i].get(dataset.target_field, ""))
                           for i in order])
        fbuck = np.asarray([_bucket(int(dataset.rows[i]["n_frames"]),
                                    cfg.frame_buckets) for i in order])
        order = order[np.lexsort((tlen, fbuck))]
    batches, batch, max_f = [], [], 0
    for i in order:
        n = int(dataset.rows[i]["n_frames"])
        nf = max(max_f, n)
        if batch and (nf * (len(batch) + 1) > cfg.max_tokens or
                      (cfg.max_sentences and len(batch) >= cfg.max_sentences)):
            # cut at a batch_multiple boundary, carry the remainder
            m = cfg.batch_multiple
            keep = len(batch) % m if len(batch) > m else 0
            batches.append(batch[:len(batch) - keep])
            batch = batch[len(batch) - keep:]
            max_f = max((int(dataset.rows[j]["n_frames"]) for j in batch),
                        default=0)
        batch.append(i)
        max_f = max(max_f, n)
    if batch:
        batches.append(batch)
    if cfg.shuffle:
        np.random.RandomState(cfg.seed + epoch).shuffle(batches)
    for batch in batches:
        yield _collate(dataset, batch, cfg)


def _load_feats(dataset: SpeechDataset, rows, feats, cfg: BatcherConfig):
    """Fill feats[:len(rows)] and return the per-example lengths: zip-member
    specs through the native loader, one call per batch."""
    tb = feats.shape[1]
    lengths = np.zeros((feats.shape[0],), np.int32)
    mode = cfg.cmvn
    if mode == "global" and dataset.global_stats is None:
        mode = "none"
    specs = [r["audio"] for r in rows]
    if all(native.is_zip_spec(s) for s in specs):
        got = native.load_feature_batch(specs, feats[:len(rows)], cmvn=mode,
                                        global_stats=dataset.global_stats)
        lengths[:len(rows)] = np.minimum(got, tb)
        return lengths
    for j, r in enumerate(rows):
        f = read_feature(r["audio"])
        if mode == "utterance":
            f = utterance_cmvn(f)
        elif mode == "global":
            f = global_cmvn(f, dataset.global_stats)
        n = min(f.shape[0], tb)
        feats[j, :n] = f[:n]
        lengths[j] = n
    return lengths


def _collate(dataset: SpeechDataset, idxs, cfg: BatcherConfig):
    rows = [dataset.rows[i] for i in idxs]
    targets = [np.asarray(dataset.vocab.encode(r[dataset.target_field]),
                          np.int32) for r in rows]
    srcs = ([np.asarray(dataset.vocab.encode(r["src_text"]), np.int32)
             for r in rows] if dataset.mtl_src else None)
    tb = _bucket(max(int(r["n_frames"]) for r in rows), cfg.frame_buckets)
    lb = _bucket(max(len(t) for t in targets), cfg.token_buckets)
    bsz = len(rows)
    b_pad = -(-bsz // cfg.batch_multiple) * cfg.batch_multiple

    feats = np.zeros((b_pad, tb, dataset.feat_dim()), np.float32)
    feat_lengths = _load_feats(dataset, rows, feats, cfg)
    target = np.full((b_pad, lb), PAD, np.int32)
    prev = np.full((b_pad, lb), PAD, np.int32)
    ids = []
    for j, (r, t) in enumerate(zip(rows, targets)):
        L = min(len(t), lb)
        tt = t[:L].copy()
        tt[-1] = EOS
        target[j, :L] = tt
        prev[j, :L] = np.asarray(move_eos_to_begin(list(tt)), np.int32)
        ids.append(r["id"])
    # padded rows keep feat_lengths 0 and all-PAD targets: they add nothing
    # to the summed losses or the sample size
    batch = {"feats": feats, "feat_lengths": feat_lengths, "target": target,
             "prev_tokens": prev, "ids": ids, "n_real": bsz}
    if srcs is not None:
        sb = _bucket(max(len(s) for s in srcs), cfg.token_buckets)
        src_target = np.full((b_pad, sb), PAD, np.int32)
        for j, s in enumerate(srcs):
            L = min(len(s), sb)
            ss = s[:L].copy()
            ss[-1] = EOS
            src_target[j, :L] = ss
        batch["src_target"] = src_target
    return batch
