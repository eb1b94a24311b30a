"""Vocabulary with fairseq Dictionary conventions (a copy of
simulst_tpu/data/vocab.py without vocab training and the native SPM
reader: the port imports nothing of the JAX package).

Special ids are pinned to fairseq's Dictionary layout: bos=0, pad=1,
eos=2, unk=3.  A fairseq-format .txt dictionary loads with `from_txt`; an
SPM .model needs the sentencepiece package.
"""
from __future__ import annotations

from typing import List, Sequence

BOS, PAD, EOS, UNK = 0, 1, 2, 3
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>"]


class Vocabulary:
    def __init__(self, symbols: Sequence[str]):
        assert list(symbols[:4]) == SPECIALS, "special ids must be pinned"
        self.symbols = list(symbols)
        self.index = {s: i for i, s in enumerate(self.symbols)}
        self.spm = None

    # -- construction ------------------------------------------------------
    @classmethod
    def from_txt(cls, path: str) -> "Vocabulary":
        """fairseq-format dict .txt: '<symbol> <count>' per line, specials
        implicit (the reference writes spm vocab this way)."""
        syms = list(SPECIALS)
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if parts and parts[0]:
                    syms.append(parts[0])
        return cls(syms)

    @classmethod
    def from_spm(cls, model_path: str) -> "Vocabulary":
        """Needs the sentencepiece package; the JAX package's native SPM
        reader (data/spm.py) is not ported."""
        import sentencepiece as sp
        m = sp.SentencePieceProcessor(model_file=model_path)
        syms = list(SPECIALS)
        for i in range(m.get_piece_size()):
            piece = m.id_to_piece(i)
            if piece not in SPECIALS:
                syms.append(piece)
        v = cls(syms)
        v.spm = m
        return v

    # -- encode / decode ----------------------------------------------------
    def __len__(self):
        return len(self.symbols)

    def encode_pieces(self, text: str) -> List[str]:
        if self.spm is not None:
            return self.spm.encode(text, out_type=str)
        # whitespace fallback with BOW marker for unit_to_segment parity
        return ["▁" + w for w in text.split()]

    def encode(self, text: str, append_eos: bool = True) -> List[int]:
        ids = [self.index.get(p, UNK) for p in self.encode_pieces(text)]
        return ids + [EOS] if append_eos else ids

    def decode_ids(self, ids: Sequence[int]) -> str:
        pieces = [self.symbols[i] for i in ids
                  if i not in (BOS, PAD, EOS)]
        return "".join(pieces).replace("▁", " ").strip()

    def string(self, ids: Sequence[int]) -> str:
        """Space-joined pieces (fairseq Dictionary.string without bpe)."""
        return " ".join(self.symbols[i] for i in ids if i != PAD)
