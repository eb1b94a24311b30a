"""TSV manifests and zip-packed feature storage (a copy of
simulst_tpu/data/manifest.py).

`{split}_st.tsv` manifests with columns (id, audio, n_frames, src_text,
tgt_text, speaker), where `audio` is `fbank80.zip:<byte_offset>:<byte_len>`
(an uncompressed .npy member) or a plain .npy path, the reference's data
layout.
"""
from __future__ import annotations

import csv
import io
import os
import zipfile
from typing import Dict, List

import numpy as np

def load_tsv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter="\t", quotechar=None,
                                doublequote=False, quoting=csv.QUOTE_NONE)
        return [dict(r) for r in reader]


def save_tsv(rows: List[Dict[str, str]], path: str):
    if not rows:
        raise ValueError("empty manifest")
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()), delimiter="\t",
                           quotechar=None, doublequote=False,
                           quoting=csv.QUOTE_NONE)
        w.writeheader()
        for r in rows:
            w.writerow(r)


def filter_by_frames(rows, min_frames: int = 5, max_frames: int = 3000):
    return [r for r in rows
            if min_frames <= int(r["n_frames"]) <= max_frames]


def create_feature_zip(features: Dict[str, np.ndarray], zip_path: str
                       ) -> Dict[str, str]:
    """Pack per-utterance features as .npy members of an uncompressed zip;
    return id -> 'zip_path:offset:length' audio specs."""
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_STORED) as zf:
        for uid, feat in features.items():
            buf = io.BytesIO()
            np.save(buf, feat.astype(np.float32))
            zf.writestr(uid + ".npy", buf.getvalue())
    specs = {}
    with zipfile.ZipFile(zip_path) as zf, open(zip_path, "rb") as raw:
        for info in zf.infolist():
            uid = info.filename[:-4]
            offset = info.header_offset + 30 + len(info.filename) + \
                len(info.extra)
            raw.seek(offset)
            if raw.read(6) != b"\x93NUMPY":
                raise ValueError(f"{zip_path}: member {uid} is not at "
                                 f"offset {offset}")
            specs[uid] = f"{os.path.abspath(zip_path)}:{offset}:{info.file_size}"
    return specs


def read_feature(audio_spec: str) -> np.ndarray:
    """Read 'path:offset:length' (zip member) or a plain .npy path."""
    parts = audio_spec.rsplit(":", 2)
    if len(parts) == 3 and parts[1].isdigit():
        path, offset, length = parts[0], int(parts[1]), int(parts[2])
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        return np.load(io.BytesIO(data))
    return np.load(audio_spec)
