"""Vocabulary with fairseq Dictionary conventions (a copy of
simulst_tpu/data/vocab.py).

Special ids are pinned to fairseq's Dictionary layout: bos=0, pad=1,
eos=2, unk=3.  A fairseq-format .txt dictionary loads with `from_txt`; an
SPM .model loads with `from_spm` and a new one trains with `build`,
through the sentencepiece package where it is installed and otherwise
through the native reader and unigram trainer of data/spm.py.
"""
from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence

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
        """The pieces of an SPM .model after the pinned specials; encodes
        with the sentencepiece package where it is installed, else with
        data/spm.py's Viterbi segmenter."""
        try:
            import sentencepiece as sp
            m = sp.SentencePieceProcessor(model_file=model_path)
        except ImportError:
            from simulst_tpu_torch.data.spm import UnigramModel, load_model
            m = UnigramModel(load_model(model_path))
        syms = list(SPECIALS)
        for i in range(m.get_piece_size()):
            piece = m.id_to_piece(i)
            if piece not in SPECIALS:
                syms.append(piece)
        v = cls(syms)
        v.spm = m
        return v

    @classmethod
    def build(cls, texts, vocab_size: int = 4096, model_type: str = "unigram",
              save_prefix: Optional[str] = None,
              user_defined: Optional[List[str]] = None) -> "Vocabulary":
        """Train an SPM vocabulary with the pinned special ids (the
        reference's gen_vocab) and write `<prefix>.model` and the
        fairseq-style `<prefix>.txt`: through the sentencepiece package
        where it is installed, else data/spm.py's unigram trainer."""
        try:
            import sentencepiece as sp
        except ImportError:
            from simulst_tpu_torch.data import spm as nspm
            pieces = nspm.train_unigram(list(texts), vocab_size=vocab_size,
                                        user_defined=user_defined)
            prefix = save_prefix or tempfile.mktemp()
            nspm.save_model(prefix + ".model", pieces)
            with open(prefix + ".txt", "w") as f:
                for p, _, _ in pieces[4:]:
                    f.write(f"{p} 1\n")
            return cls.from_spm(prefix + ".model")
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as f:
            for t in texts:
                f.write(t + "\n")
            tmp = f.name
        prefix = save_prefix or tempfile.mktemp()
        kwargs = {}
        if user_defined:
            kwargs["user_defined_symbols"] = ",".join(user_defined)
        sp.SentencePieceTrainer.train(
            input=tmp, model_prefix=prefix, model_type=model_type,
            vocab_size=vocab_size, unk_id=UNK, bos_id=BOS, eos_id=EOS,
            pad_id=PAD, character_coverage=1.0, **kwargs)
        os.unlink(tmp)
        return cls.from_spm(prefix + ".model")

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
