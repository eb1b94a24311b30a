"""MuST-C data preparation (counterpart of simulst_tpu/data/mustc.py).

Parses each split's segment list (`txt/{split}.yaml`) and its transcript
and translation files, cuts the wav segments, computes the 80-dim fbank
with ops/fbank on the card (the CPU when the caller asks for it), packs the
features into an uncompressed zip, writes `{split}_st.tsv` manifests,
trains the SPM vocabulary with the pinned special ids, writes the data
config and the global CMVN stats, and builds the long-utterance
robustness splits (consecutive segments concatenated to at least N
seconds) and the streaming evaluator's wav / reference lists.

The GPU machine has no PyYAML, so MuST-C's segment lists (one flow mapping
per line, `- {duration: 3.52, offset: 16.5, speaker_id: spk.1, wav:
ted_1.wav}`) are read by `load_segment_yaml`, and the data config is
written by `dump_yaml`; both follow PyYAML's safe rules for the scalars
and layouts they meet there.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from simulst_tpu_torch.data import manifest as mf
from simulst_tpu_torch.data.features import compute_global_cmvn
from simulst_tpu_torch.data.vocab import Vocabulary
from simulst_tpu_torch.data.wav import read_wav
from simulst_tpu_torch.nn.core import resolve_device
from simulst_tpu_torch.ops.fbank import fbank_batch

SPLITS = ["train", "dev", "tst-COMMON", "tst-HE"]
SAMPLE_RATE = 16000

# ---------------------------------------------------------------------------
# the YAML subset of MuST-C's segment lists and the data config
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers, for the scalars met here
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off "
                                    "OFF")) for v in vs.split()}
_NULL = {"", "~", "null", "Null", "NULL"}


def _plain_scalar(text: str):
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(text.replace("_", ""))
    return text


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return text[1:-1].encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    return _plain_scalar(text)


def _split_flow(body: str) -> List[str]:
    """Split a flow mapping's body at its top-level commas."""
    parts, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur.append(ch)
        elif ch == ",":
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return parts


def _split_key(item: str) -> Tuple[str, str]:
    """'key: value' at the first ': ' (or a trailing ':') outside quotes."""
    quote = None
    for i, ch in enumerate(item):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(item) or item[i + 1] == " "):
            return item[:i], item[i + 1:]
    raise ValueError(f"no key in {item!r}")


def load_segment_yaml(text: str) -> List[Dict]:
    """A YAML sequence of one-line flow mappings -> list of dicts, the
    scalars typed as yaml.safe_load types them."""
    out = []
    for n, line in enumerate(text.splitlines(), 1):
        s = line.strip()
        if not s or s.startswith("#") or s == "---":
            continue
        m = re.match(r"^-\s*\{(.*)\}\s*(?:#.*)?$", s)
        if m is None:
            raise ValueError(f"line {n}: not a '- {{key: value, ...}}' "
                             f"segment: {line!r}")
        seg = {}
        for item in _split_flow(m.group(1)):
            key, value = _split_key(item.strip())
            seg[_scalar(key)] = _scalar(value)
        out.append(seg)
    return out


def _yaml_str(s: str) -> str:
    """A plain scalar where it reads back as the same string, else single
    quoted, as yaml.safe_dump writes it."""
    plain = (s and s == s.strip() and _plain_scalar(s) == s
             and s[0] not in "-?:,[]{}#&*!|>'\"%@`"
             and ": " not in s and " #" not in s and not s.endswith(":"))
    return s if plain else "'" + s.replace("'", "''") + "'"


def _yaml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, (int, float)):
        return repr(v)
    return _yaml_str(str(v))


def dump_yaml(data: Dict, indent: int = 0) -> str:
    """Block-style YAML of nested dicts, lists and scalars, keys sorted:
    yaml.safe_dump's text for the data config."""
    pad = " " * indent
    lines = []
    for key in sorted(data):
        v = data[key]
        k = _yaml_str(str(key))
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:")
            lines.append(dump_yaml(v, indent + 2).rstrip("\n"))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{k}:")
            lines += [f"{pad}- {_yaml_value(x)}" for x in v]
        else:
            lines.append(f"{pad}{k}: {_yaml_value(v)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# preparation
# ---------------------------------------------------------------------------

_NOISE_TAG = re.compile(r"\([A-Z][a-zA-Z ]*\)")  # (Applause), (Laughter)


def strip_noise_tags(text: str) -> str:
    """Remove parenthesized event tags from transcripts."""
    return " ".join(_NOISE_TAG.sub(" ", text).split())


def parse_segments(root: str, split: str, src_lang: str, tgt_lang: str
                   ) -> List[Dict]:
    """{split}.yaml + {split}.{src,tgt}: one dict per segment with its
    text, wav path and id `<wav stem>_<index>`."""
    base = Path(root) / f"en-{tgt_lang}" / "data" / split
    with open(base / "txt" / f"{split}.yaml") as f:
        segments = load_segment_yaml(f.read())
    for lang in (src_lang, tgt_lang):
        with open(base / "txt" / f"{split}.{lang}") as f:
            lines = [line.strip() for line in f]
        if len(lines) != len(segments):
            raise ValueError(f"{split}.{lang}: {len(lines)} lines for "
                             f"{len(segments)} segments")
        key = "src_text" if lang == src_lang else "tgt_text"
        for seg, line in zip(segments, lines):
            seg[key] = line
    for i, seg in enumerate(segments):
        seg["wav_path"] = str(base / "wav" / seg["wav"])
        seg["id"] = f"{Path(seg['wav']).stem}_{i}"
    return segments


def iter_segment_audio(segments: List[Dict]
                       ) -> Iterator[Tuple[str, np.ndarray]]:
    """(utt id, waveform in [-1, 1)) for [offset, offset + duration) of
    each segment, each wav file read once."""
    by_wav: Dict[str, List[Dict]] = {}
    for s in segments:
        by_wav.setdefault(s["wav_path"], []).append(s)
    for wav_path, segs in by_wav.items():
        data, sr = read_wav(wav_path)
        if sr != SAMPLE_RATE:
            raise ValueError(f"{wav_path}: {sr} Hz, expected {SAMPLE_RATE}")
        for s in segs:
            a = int(float(s["offset"]) * sr)
            b = a + int(float(s["duration"]) * sr)
            yield s["id"], data[a:b]


def segment_fbank(wav: np.ndarray, device=None) -> np.ndarray:
    """(T, 80) fbank of one segment (samples in [-1, 1)), computed on
    `device` (the card unless the caller names another)."""
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32) * 2 ** 15)
    return fbank_batch(x[None].to(resolve_device(device)))[0].cpu().numpy()


def process_split(root: str, split: str, out_dir: str, src_lang: str = "en",
                  tgt_lang: str = "de", device=None) -> List[Dict[str, str]]:
    """fbank -> zip -> manifest rows of one split; the train split keeps
    5 to 3000 frames."""
    os.makedirs(out_dir, exist_ok=True)
    segments = parse_segments(root, split, src_lang, tgt_lang)
    feats = {uid: segment_fbank(wav, device)
             for uid, wav in iter_segment_audio(segments)}
    specs = mf.create_feature_zip(
        feats, os.path.join(out_dir, f"fbank80_{split}.zip"))
    rows = [{"id": s["id"], "audio": specs[s["id"]],
             "n_frames": str(feats[s["id"]].shape[0]),
             "src_text": s["src_text"], "tgt_text": s["tgt_text"],
             "speaker": s.get("speaker_id", "unknown")} for s in segments]
    if split == "train":
        rows = mf.filter_by_frames(rows)
    mf.save_tsv(rows, os.path.join(out_dir, f"{split}_st.tsv"))
    return rows


def write_gcmvn(out_dir: str, train_rows: List[Dict[str, str]]) -> str:
    """Global CMVN stats over the train features -> out_dir/gcmvn.npz."""
    stats = compute_global_cmvn(mf.read_feature(r["audio"])
                                for r in train_rows)
    path = os.path.join(out_dir, "gcmvn.npz")
    np.savez(path, **stats)
    return path


def build_vocab(train_rows: List[Dict[str, str]], out_dir: str,
                vocab_size: int = 4096, fields=("tgt_text",)) -> Vocabulary:
    texts = [r[f] for r in train_rows for f in fields]
    prefix = os.path.join(out_dir, f"spm_unigram{vocab_size}_st")
    return Vocabulary.build(texts, vocab_size=vocab_size, save_prefix=prefix)


def data_config(vocab_size: int = 4096) -> Dict:
    """The reference's gen_config_yaml content."""
    return {
        "vocab_filename": f"spm_unigram{vocab_size}_st.txt",
        "bpe_tokenizer": {"bpe": "sentencepiece",
                          "sentencepiece_model":
                              f"spm_unigram{vocab_size}_st.model"},
        "input_channels": 1,
        "input_feat_per_channel": 80,
        "sampling_alpha": 1.0,
        "use_audio_input": False,
        "specaugment": {"freq_mask_F": 27, "freq_mask_N": 2,
                        "time_mask_N": 2, "time_mask_T": 100,
                        "time_mask_p": 1.0, "time_wrap_W": 0},
        "transforms": {"_train": ["specaugment"], "*": ["utterance_cmvn"]},
    }


def write_config(out_dir: str, vocab_size: int = 4096):
    """out_dir/config_st.yaml."""
    with open(os.path.join(out_dir, "config_st.yaml"), "w") as f:
        f.write(dump_yaml(data_config(vocab_size)))


def build_long_utterances(segments: List[Dict], min_seconds: float
                          ) -> List[List[Dict]]:
    """Consecutive same-wav segments grouped until they reach min_seconds
    (the 20 / 40 / 60 s robustness splits)."""
    groups, cur, dur = [], [], 0.0
    prev_wav = None
    for s in segments:
        if prev_wav is not None and s["wav_path"] != prev_wav and cur:
            groups.append(cur)
            cur, dur = [], 0.0
        cur.append(s)
        dur += float(s["duration"])
        prev_wav = s["wav_path"]
        if dur >= min_seconds:
            groups.append(cur)
            cur, dur = [], 0.0
    if cur:
        groups.append(cur)
    return groups


def process_long_split(root: str, split: str, out_dir: str,
                       min_seconds: float, src_lang: str = "en",
                       tgt_lang: str = "de") -> int:
    """A long-utterance split: per group one int16 wav, the wav list and
    the joined references.  Returns the group count."""
    from scipy.io import wavfile
    segments = parse_segments(root, split, src_lang, tgt_lang)
    groups = build_long_utterances(segments, min_seconds)
    tag = f"{split}-{int(min_seconds)}s"
    wav_dir = os.path.join(out_dir, tag + "_wavs")
    os.makedirs(wav_dir, exist_ok=True)
    wav_list, refs = [], []
    cache: Dict[str, np.ndarray] = {}
    for gi, group in enumerate(groups):
        wp = group[0]["wav_path"]
        if wp not in cache:
            cache.clear()           # groups are wav-contiguous
            cache[wp], _ = read_wav(wp)
        data = cache[wp]
        parts = []
        for s in group:
            a = int(float(s["offset"]) * SAMPLE_RATE)
            parts.append(data[a:a + int(float(s["duration"]) * SAMPLE_RATE)])
        path = os.path.join(wav_dir, f"{tag}_{gi}.wav")
        wavfile.write(path, SAMPLE_RATE,
                      (np.concatenate(parts) * 32767).astype(np.int16))
        wav_list.append(os.path.abspath(path))
        refs.append(" ".join(s["tgt_text"] for s in group))
    with open(os.path.join(out_dir, tag + ".wav_list"), "w") as f:
        f.write("\n".join(wav_list) + "\n")
    with open(os.path.join(out_dir, f"{tag}.{tgt_lang}"), "w") as f:
        f.write("\n".join(refs) + "\n")
    return len(groups)


def write_simul_lists(rows: List[Dict[str, str]], wav_dir: str,
                      out_prefix: str, tgt_lang: str = "de"):
    """{prefix}.wav_list and {prefix}.{lang} for the streaming evaluator."""
    with open(out_prefix + ".wav_list", "w") as fw, \
            open(out_prefix + "." + tgt_lang, "w") as ft:
        for r in rows:
            fw.write(os.path.join(wav_dir, r["id"] + ".wav") + "\n")
            ft.write(r["tgt_text"] + "\n")
