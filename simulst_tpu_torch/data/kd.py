"""Sequence-level knowledge distillation manifests (a copy of
simulst_tpu/data/kd.py): a train manifest's tgt_text replaced by the MT
teacher's translations, read from cli/generate's fairseq-style D- lines
by sample id (the reference's DATA/create_distillation_tsv.py).
"""
from __future__ import annotations

from typing import Dict

from simulst_tpu_torch.data import manifest as mf


def parse_generation_output(lines) -> Dict[int, str]:
    """{id: hypothesis} of the 'D-<id>\\t<score>\\t<text>' lines."""
    out = {}
    for line in lines:
        if line.startswith("D-"):
            parts = line.rstrip("\n").split("\t")
            out[int(parts[0][2:])] = parts[2] if len(parts) > 2 else ""
    return out


def create_distillation_tsv(train_tsv: str, generation_output: str,
                            out_tsv: str) -> int:
    """Write train_tsv with each row's tgt_text replaced by the hypothesis
    of its index in generation_output; returns the rows left without
    one."""
    rows = mf.load_tsv(train_tsv)
    with open(generation_output) as f:
        hyps = parse_generation_output(f)
    missing = 0
    for i, r in enumerate(rows):
        if i in hyps:
            r["tgt_text"] = hyps[i]
        else:
            missing += 1
    mf.save_tsv(rows, out_tsv)
    return missing
