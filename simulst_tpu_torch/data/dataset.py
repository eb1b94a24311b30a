"""The batching pieces the text dataset uses (a copy from
simulst_tpu/data/dataset.py: BatcherConfig, _bucket, move_eos_to_begin;
the speech dataset is not ported yet) and the tsv manifest reader (from
simulst_tpu/data/manifest.py).
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

from simulst_tpu_torch.data.vocab import EOS


@dataclasses.dataclass
class BatcherConfig:
    """The fields the text batcher reads (the speech batcher's frame
    buckets, CMVN and target sort come with the speech dataset)."""
    max_tokens: int = 40000          # tokens per batch, --max-tokens
    max_sentences: Optional[int] = None
    token_buckets: Sequence[int] = tuple(range(8, 128 + 1, 8))
    shuffle: bool = True
    seed: int = 1
    batch_multiple: int = 8          # pad batch size to a multiple


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def move_eos_to_begin(tokens: List[int]) -> List[int]:
    """prev_output_tokens construction (fairseq convention)."""
    assert tokens[-1] == EOS
    return [EOS] + tokens[:-1]


def load_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t", quotechar=None,
                                doublequote=False, quoting=csv.QUOTE_NONE)
        return [dict(r) for r in reader]
