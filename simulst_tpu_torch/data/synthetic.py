"""Seeded synthetic data until real MuST-C / WMT data is in the
repository: token batches for MT training, and MuST-C-shaped speech
manifests (a copy of simulst_tpu/data/synthetic.py `mustc_like_rows`)."""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from simulst_tpu_torch.data import manifest as mf
from simulst_tpu_torch.data.vocab import EOS, PAD


def synthetic_pairs(rng: np.random.RandomState, n: int, lo: int, hi: int,
                    vocab: int) -> Dict[str, np.ndarray]:
    """n sentence pairs of lo..hi tokens each (EOS last, ids drawn from
    4..vocab-1), right-padded to hi: src_tokens, target and prev_tokens
    (EOS moved to the front), int64 (n, hi)."""
    src = np.full((n, hi), PAD, np.int64)
    tgt = np.full((n, hi), PAD, np.int64)
    prev = np.full((n, hi), PAD, np.int64)
    for j in range(n):
        ls, lt = rng.randint(lo, hi + 1, size=2)
        src[j, :ls] = np.append(rng.randint(4, vocab, ls - 1), EOS)
        tgt[j, :lt] = np.append(rng.randint(4, vocab, lt - 1), EOS)
        prev[j, :lt] = np.append(EOS, tgt[j, :lt - 1])
    return {"src_tokens": src, "target": tgt, "prev_tokens": prev}


def mustc_like_rows(n: int = 3000, seed: int = 0, tmpdir: str = ".",
                    feat_dim: int = 4, chars_per_sec: float = 17.0
                    ) -> List[Dict[str, str]]:
    """Manifest rows (with a real zero-feature zip under tmpdir) whose
    duration / target-length joint distribution is MuST-C en-de shaped:
    lognormal durations around 6 s clipped to 1-20 s, about 17 target
    characters per second with +-25 % noise."""
    rng = np.random.RandomState(seed)
    secs = np.clip(np.exp(rng.normal(1.7, 0.55, n)), 1.0, 20.0)
    frames = (secs * 100).astype(int)
    words = []
    for s in secs:
        n_chars = max(4, int(s * chars_per_sec * rng.uniform(0.75, 1.25)))
        w, left = [], n_chars
        while left > 0:
            wl = int(rng.randint(2, 9))
            w.append("".join(rng.choice(list("abcdefghij"), wl)))
            left -= wl + 1
        words.append(" ".join(w))
    feats = {f"u{i}": np.zeros((int(frames[i]), feat_dim), np.float32)
             for i in range(n)}
    specs = mf.create_feature_zip(feats, os.path.join(tmpdir,
                                                      "synthetic_feats.zip"))
    return [{"id": f"u{i}", "audio": specs[f"u{i}"],
             "n_frames": str(int(frames[i])), "src_text": words[i],
             "tgt_text": words[i], "speaker": "s"} for i in range(n)]


_EN = ("the", "model", "listens", "to", "speech", "and", "writes", "words",
       "while", "people", "talk", "about", "music", "science", "water",
       "light", "cities", "we", "can", "see", "new", "ideas", "every", "day")
_DE = ("das", "modell", "hoert", "der", "sprache", "zu", "und", "schreibt",
       "woerter", "waehrend", "menschen", "ueber", "musik", "wissenschaft",
       "wasser", "licht", "staedte", "wir", "koennen", "sehen", "neue",
       "ideen", "jeden", "tag")


def write_mustc_tree(root: str, split: str, n_segments: int, n_talks: int = 2,
                     seed: int = 0, min_s: float = 2.0, max_s: float = 12.0,
                     tgt_lang: str = "de", sample_rate: int = 16000
                     ) -> List[Dict]:
    """A seeded MuST-C split under root/en-<tgt>/data/<split>: n_talks int16
    wav files (ted_<seed><k>.wav) of consecutive segments, min_s-max_s s
    each with short pauses between them, one tone per word (its pitch from
    the word), and the segment list txt/<split>.yaml (one flow mapping per
    line, as MuST-C's), txt/<split>.en and txt/<split>.<tgt>.  Returns the
    segments."""
    from scipy.io import wavfile
    rng = np.random.RandomState(seed)
    base = os.path.join(root, f"en-{tgt_lang}", "data", split)
    os.makedirs(os.path.join(base, "txt"), exist_ok=True)
    os.makedirs(os.path.join(base, "wav"), exist_ok=True)
    segments = []
    per_talk = np.array_split(np.arange(n_segments), n_talks)
    for k, idx in enumerate(per_talk):
        wav_name = f"ted_{seed}{k}.wav"
        t, audio = 0.5, [np.zeros(sample_rate // 2, np.float32)]
        for _ in idx:
            dur = round(float(rng.uniform(min_s, max_s)), 2)
            n_words = max(1, int(dur / 0.5))
            words = rng.randint(0, len(_EN), n_words)
            slot = int(dur * sample_rate) // n_words
            tt = np.arange(slot) / sample_rate
            for w in words:
                audio.append((0.3 * np.sin(2 * np.pi * (200 + 40 * w) * tt)
                              * np.hanning(slot)).astype(np.float32))
            audio.append(np.zeros(int(dur * sample_rate) - slot * n_words
                                  + sample_rate // 4, np.float32))
            segments.append({"duration": dur, "offset": round(t, 2),
                             "speaker_id": f"spk.{k}", "wav": wav_name,
                             "en": " ".join(_EN[w] for w in words),
                             tgt_lang: " ".join(_DE[w] for w in words)})
            t = round(t + dur + 0.25, 2)
        pcm = np.concatenate(audio + [np.zeros(sample_rate, np.float32)])
        wavfile.write(os.path.join(base, "wav", wav_name), sample_rate,
                      (pcm * 32767).astype(np.int16))
    with open(os.path.join(base, "txt", f"{split}.yaml"), "w") as f:
        for s in segments:
            f.write(f"- {{duration: {s['duration']:.6f}, offset: "
                    f"{s['offset']:.6f}, rW: 0, uW: 0, speaker_id: "
                    f"{s['speaker_id']}, wav: {s['wav']}}}\n")
    for lang in ("en", tgt_lang):
        with open(os.path.join(base, "txt", f"{split}.{lang}"), "w") as f:
            f.write("".join(s[lang] + "\n" for s in segments))
    return segments
