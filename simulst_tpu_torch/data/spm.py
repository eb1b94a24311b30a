"""Native SentencePiece (a copy of simulst_tpu/data/spm.py, plain Python):
ModelProto IO, unigram Viterbi encoding and the unigram trainer.

The reference trains and loads its `spm_unigram4096` vocabularies through
the sentencepiece C++ package, which neither the CPU nor the GPU machine
of this port has.  This module covers the needed surface with no
dependency:

  * `load_model` / `save_model`: the SentencePiece ModelProto wire format
    (protobuf: field 1 = repeated SentencePiece{1: piece, 2: score,
    3: type}), enough to read released `.model` files and to write
    interoperable ones.
  * `UnigramModel.encode`: NFKC + whitespace escaping with a dummy
    prefix, then a Viterbi pass over the piece lattice (max-score
    segmentation).
  * `train_unigram`: frequent-substring seeding, EM over the segmentation
    lattice (forward-backward expected counts) and pruning to the target
    size, single characters kept (character_coverage 1.0).  Scores are log
    piece probabilities; segmentation follows SentencePiece's closely but
    not bit for bit.

Piece ids are pinned as the reference's gen_vocab pins them: 0..3 = <s>,
<pad>, </s>, <unk>, then user_defined symbols, then the learned pieces by
descending score.
"""
from __future__ import annotations

import math
import struct
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

BOW = "▁"  # ▁


# ---------------------------------------------------------------------------
# ModelProto wire format
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    value: bytes for wire 2, int for wire 0, raw 4/8 bytes for wire 5/1."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_piece(buf: bytes) -> Tuple[str, float, int]:
    piece, score, typ = "", 0.0, NORMAL
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            piece = val.decode("utf-8")
        elif field == 2:
            score = struct.unpack("<f", val)[0]
        elif field == 3:
            typ = val
    return piece, score, typ


def load_model(path: str) -> List[Tuple[str, float, int]]:
    """Read a SentencePiece .model file -> [(piece, score, type)] in id order."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == 2:
            pieces.append(_parse_piece(val))
    return pieces


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def save_model(path: str, pieces: Sequence[Tuple[str, float, int]]) -> None:
    """Write [(piece, score, type)] as a SentencePiece-compatible ModelProto."""
    out = bytearray()
    for piece, score, typ in pieces:
        body = bytearray()
        pb = piece.encode("utf-8")
        body += _field(1, 2) + _varint(len(pb)) + pb
        body += _field(2, 5) + struct.pack("<f", score)
        if typ != NORMAL:
            body += _field(3, 0) + _varint(typ)
        out += _field(1, 2) + _varint(len(body)) + bytes(body)
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------------------------------------------------------------------
# normalization (SentencePiece defaults: NFKC, collapse spaces, dummy prefix)
# ---------------------------------------------------------------------------

def normalize(text: str, add_dummy_prefix: bool = True) -> str:
    text = unicodedata.normalize("NFKC", text)
    text = " ".join(text.split())
    if not text:
        return ""
    if add_dummy_prefix:
        text = " " + text
    return text.replace(" ", BOW)


# ---------------------------------------------------------------------------
# unigram segmentation
# ---------------------------------------------------------------------------

class UnigramModel:
    """Viterbi unigram segmenter over a scored piece inventory."""

    def __init__(self, pieces: Sequence[Tuple[str, float, int]]):
        self.pieces = list(pieces)
        self.scores: Dict[str, float] = {}
        self.unk_piece = "<unk>"
        self.unk_id = 0
        for i, (p, s, t) in enumerate(self.pieces):
            if t in (NORMAL, USER_DEFINED):
                self.scores[p] = s
            elif t == UNKNOWN:
                self.unk_piece, self.unk_id = p, i
        self.max_len = max((len(p) for p in self.scores), default=1)
        min_score = min(self.scores.values(), default=0.0)
        self.unk_score = min_score - 10.0
        self._index = {p: i for i, (p, _, _) in enumerate(self.pieces)}

    def piece_to_id(self, piece: str) -> int:
        return self._index.get(piece, self.unk_id)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    def get_piece_size(self) -> int:
        return len(self.pieces)

    def encode(self, text: str, out_type=str) -> List:
        """Segment raw text -> pieces (or ids). Unknown characters come back
        as their raw character (mapped to unk by piece_to_id)."""
        s = normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = -1e18
        best = [NEG] * (n + 1)
        back = [0] * (n + 1)
        best[0] = 0.0
        for i in range(1, n + 1):
            lo = max(0, i - self.max_len)
            for j in range(lo, i):
                if best[j] == NEG:
                    continue
                sc = self.scores.get(s[j:i])
                if sc is not None and best[j] + sc > best[i]:
                    best[i] = best[j] + sc
                    back[i] = j
            if best[i] == NEG:  # unknown char fallback
                best[i] = best[i - 1] + self.unk_score
                back[i] = i - 1
        out = []
        i = n
        while i > 0:
            j = back[i]
            out.append(s[j:i])
            i = j
        out.reverse()
        if out_type is str:
            return out
        return [self.piece_to_id(p) for p in out]

    # -- EM support ---------------------------------------------------------
    def expected_counts(self, s: str, counts: Dict[str, float]) -> float:
        """Forward-backward over the segmentation lattice of a NORMALIZED
        string; accumulates expected piece counts. Returns the sentence
        log-likelihood."""
        n = len(s)
        if n == 0:
            return 0.0
        # forward / backward in log space
        fwd = [-math.inf] * (n + 1)
        fwd[0] = 0.0
        edges: List[List[Tuple[int, str, float]]] = [[] for _ in range(n + 1)]
        for i in range(1, n + 1):
            lo = max(0, i - self.max_len)
            for j in range(lo, i):
                sc = self.scores.get(s[j:i])
                if sc is not None:
                    edges[i].append((j, s[j:i], sc))
            if not edges[i]:
                edges[i].append((i - 1, s[i - 1:i], self.unk_score))
            for j, piece, sc in edges[i]:
                if fwd[j] > -math.inf:
                    v = fwd[j] + sc
                    fwd[i] = v if fwd[i] == -math.inf else \
                        max(fwd[i], v) + math.log1p(math.exp(-abs(fwd[i] - v)))
        bwd = [-math.inf] * (n + 1)
        bwd[n] = 0.0
        for i in range(n, 0, -1):
            if bwd[i] == -math.inf:
                continue
            for j, piece, sc in edges[i]:
                v = bwd[i] + sc
                bwd[j] = v if bwd[j] == -math.inf else \
                    max(bwd[j], v) + math.log1p(math.exp(-abs(bwd[j] - v)))
        z = fwd[n]
        if z == -math.inf:
            return 0.0
        for i in range(1, n + 1):
            for j, piece, sc in edges[i]:
                if fwd[j] > -math.inf and bwd[i] > -math.inf:
                    counts[piece] = counts.get(piece, 0.0) + \
                        math.exp(fwd[j] + sc + bwd[i] - z)
        return z


# ---------------------------------------------------------------------------
# unigram trainer
# ---------------------------------------------------------------------------

def _seed_pieces(sentences: List[str], seed_size: int, max_piece_len: int = 10
                 ) -> Dict[str, float]:
    """Frequent-substring seed inventory, scored by count * length (the
    suffix-array seeding heuristic)."""
    subs: Counter = Counter()
    chars: Counter = Counter()
    for s in sentences:
        n = len(s)
        for i in range(n):
            chars[s[i]] += 1
            for L in range(2, min(max_piece_len, n - i) + 1):
                p = s[i:i + L]
                # split_by_whitespace: pieces never cross word boundaries
                # (BOW only allowed at position 0)
                if BOW in p[1:]:
                    break
                subs[p] += 1
    seed: Dict[str, float] = {c: float(cnt) for c, cnt in chars.items()}
    scored = sorted(((cnt * len(p), p) for p, cnt in subs.items()
                     if cnt >= 2), reverse=True)
    for val, p in scored[: max(seed_size - len(seed), 0)]:
        seed[p] = float(val)
    return seed


def train_unigram(texts: Iterable[str], vocab_size: int = 4096,
                  user_defined: Optional[List[str]] = None,
                  n_em_iters: int = 2, prune_frac: float = 0.75,
                  max_sentences: int = 200000
                  ) -> List[Tuple[str, float, int]]:
    """Train a unigram piece inventory; returns the full piece list in the
    reference's pinned id layout (specials, user_defined, learned-by-score)."""
    user_defined = user_defined or []
    sentences = []
    for t in texts:
        s = normalize(t)
        if s:
            sentences.append(s)
        if len(sentences) >= max_sentences:
            break
    if not sentences:
        raise ValueError("no training text")

    n_specials = 4
    target = max(vocab_size - n_specials - len(user_defined), 1)
    seed_size = min(max(target * 4, 1000), 100000)
    inventory = _seed_pieces(sentences, seed_size)
    # user_defined symbols never segment internally: handled by the encoder's
    # score table, excluded from EM
    for u in user_defined:
        inventory.pop(u, None)

    def to_scores(counts: Dict[str, float]) -> Dict[str, float]:
        total = sum(counts.values())
        return {p: math.log(c / total) for p, c in counts.items() if c > 0}

    scores = to_scores(inventory)
    single_chars = {p for p in inventory if len(p) == 1}

    while True:
        model = UnigramModel(
            [(p, s, NORMAL) for p, s in scores.items()] +
            [("<unk>", 0.0, UNKNOWN)])
        for _ in range(n_em_iters):
            counts: Dict[str, float] = {}
            for s in sentences:
                model.expected_counts(s, counts)
            # keep required single chars alive even at zero expectation
            for c in single_chars:
                counts[c] = max(counts.get(c, 0.0), 1e-6)
            scores = to_scores(counts)
            model = UnigramModel(
                [(p, s, NORMAL) for p, s in scores.items()] +
                [("<unk>", 0.0, UNKNOWN)])
        multi = [(p, s) for p, s in scores.items() if len(p) > 1]
        n_keep_multi = max(target - len(single_chars), 0)
        if len(multi) <= n_keep_multi:
            break
        # prune lowest expected-likelihood-contribution pieces
        next_multi = max(int(len(multi) * prune_frac), n_keep_multi)
        multi.sort(key=lambda x: x[1], reverse=True)
        kept = dict(multi[:next_multi])
        kept.update({p: scores[p] for p in single_chars if p in scores})
        for c in single_chars:
            kept.setdefault(c, min(scores.values()) - 1.0)
        scores = kept
        if next_multi == n_keep_multi:
            # one final EM on the pruned inventory
            model = UnigramModel(
                [(p, s, NORMAL) for p, s in scores.items()] +
                [("<unk>", 0.0, UNKNOWN)])
            counts = {}
            for s in sentences:
                model.expected_counts(s, counts)
            for c in single_chars:
                counts[c] = max(counts.get(c, 0.0), 1e-6)
            scores = to_scores(counts)
            break

    learned = sorted(((p, s) for p, s in scores.items()),
                     key=lambda x: x[1], reverse=True)[:target]
    pieces: List[Tuple[str, float, int]] = [
        ("<s>", 0.0, CONTROL), ("<pad>", 0.0, CONTROL),
        ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN)]
    pieces += [(u, 0.0, USER_DEFINED) for u in user_defined]
    pieces += [(p, s, NORMAL) for p, s in learned]
    return pieces
