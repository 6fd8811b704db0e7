"""Pure-Python SentencePiece ``.model`` proto reader + encoder/decoder.

The reference tokenizer is SentencePiece-proto based
(``nlp/gemma/gemma_tokenizer.py:23``) and Gemma's canonical checkpoints
ship a ``tokenizer.model`` ModelProto. No ``sentencepiece`` wheel exists in
this image, so this module implements the capability directly:

* :func:`parse_model_proto` / :func:`serialize_model_proto` — the ModelProto
  wire format (``sentencepiece_model.proto``: pieces with scores/types,
  TrainerSpec special ids + model_type, NormalizerSpec whitespace flags);
* :class:`SentencePieceModel` — encode/decode for both UNIGRAM (Viterbi
  max-score segmentation, the Gemma model type) and BPE (best-scored-pair
  merge loop), with byte fallback (``<0xNN>`` pieces) and control-token
  handling.

Scope note: NFKC normalization via the precompiled charsmap is NOT
implemented (the charsmap is an opaque Darts trie blob); whitespace
normalization (dummy prefix, ``▁`` escaping, extra-whitespace removal)
follows the NormalizerSpec flags. Gemma's shipped proto performs no
additional NFKC mapping for ASCII/most text, so round-trips are exact for
practical prompts; if the real ``sentencepiece`` wheel is available the
tokenizer prefers it (``tokenizer.py:_load_backend``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterable, Optional, Sequence

WS = "▁"  # ▁ — SentencePiece whitespace escape

# SentencePiece.Type enum
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_UNK_PENALTY = 10.0  # sentencepiece's kUnkPenalty (unigram_model.cc)


# -- protobuf wire helpers ---------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | 0x80 if n else bits)
        if not n:
            return bytes(out)


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(data: bytes):
    """Yield (field_number, wire_type, value) over a message's bytes."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(data, i)
        elif wt == 1:
            val = data[i : i + 8]
            i += 8
        elif wt == 5:
            val = data[i : i + 4]
            i += 4
        elif wt == 2:
            ln, i = _read_varint(data, i)
            val = data[i : i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield num, wt, val


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


# -- model proto -------------------------------------------------------------


@dataclasses.dataclass
class SentencePiece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclasses.dataclass
class SPModelProto:
    pieces: list
    model_type: int = 1  # 1=UNIGRAM 2=BPE (TrainerSpec.ModelType)
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


def parse_model_proto(data: bytes) -> SPModelProto:
    """Parse a serialized ``ModelProto`` (the bytes of a ``.model`` file)."""
    proto = SPModelProto(pieces=[])
    for num, wt, val in _fields(data):
        if num == 1 and wt == 2:  # repeated SentencePiece pieces
            sp = SentencePiece(piece="")
            for fnum, fwt, fval in _fields(val):
                if fnum == 1:
                    sp.piece = fval.decode("utf-8")
                elif fnum == 2:
                    sp.score = struct.unpack("<f", fval)[0]
                elif fnum == 3:
                    sp.type = fval
            proto.pieces.append(sp)
        elif num == 2 and wt == 2:  # TrainerSpec
            for fnum, fwt, fval in _fields(val):
                if fnum == 3:
                    proto.model_type = fval
                elif fnum == 35:
                    proto.byte_fallback = bool(fval)
                elif fnum == 40:
                    proto.unk_id = _signed32(fval)
                elif fnum == 41:
                    proto.bos_id = _signed32(fval)
                elif fnum == 42:
                    proto.eos_id = _signed32(fval)
                elif fnum == 43:
                    proto.pad_id = _signed32(fval)
        elif num == 3 and wt == 2:  # NormalizerSpec
            for fnum, fwt, fval in _fields(val):
                if fnum == 3:
                    proto.add_dummy_prefix = bool(fval)
                elif fnum == 4:
                    proto.remove_extra_whitespaces = bool(fval)
                elif fnum == 5:
                    proto.escape_whitespaces = bool(fval)
    return proto


def _signed32(v: int) -> int:
    """int32 fields are varint-encoded as 64-bit two's complement."""
    return v - (1 << 64) if v >= (1 << 63) else v


def serialize_model_proto(proto: SPModelProto) -> bytes:
    """Inverse of :func:`parse_model_proto` — writes a ``.model`` file
    sentencepiece itself can load (used by tooling/tests to build protos
    from trained vocabularies)."""
    out = bytearray()
    for sp in proto.pieces:
        body = _field_bytes(1, sp.piece.encode("utf-8"))
        body += _field_float(2, sp.score)
        if sp.type != NORMAL:
            body += _field_varint(3, sp.type)
        out += _field_bytes(1, body)
    trainer = (
        _field_varint(3, proto.model_type)
        + _field_varint(35, int(proto.byte_fallback))
        + _field_varint(40, proto.unk_id)
        + _field_varint(41, proto.bos_id)
        + _field_varint(42, proto.eos_id)
        + _field_varint(43, proto.pad_id)
    )
    out += _field_bytes(2, trainer)
    norm = (
        _field_varint(3, int(proto.add_dummy_prefix))
        + _field_varint(4, int(proto.remove_extra_whitespaces))
        + _field_varint(5, int(proto.escape_whitespaces))
    )
    out += _field_bytes(3, norm)
    return bytes(out)


# -- encoder / decoder -------------------------------------------------------


class SentencePieceModel:
    """Drop-in tokenizer backend (``encode``/``decode``/``*_id`` protocol of
    ``tokenizer.py``) over a parsed ModelProto."""

    def __init__(self, proto_or_path):
        if isinstance(proto_or_path, SPModelProto):
            self.proto = proto_or_path
        elif isinstance(proto_or_path, (bytes, bytearray)):
            self.proto = parse_model_proto(bytes(proto_or_path))
        else:
            with open(proto_or_path, "rb") as f:
                self.proto = parse_model_proto(f.read())
        p = self.proto
        self._id_of = {}
        self._byte_ids = {}
        scores = []
        for i, sp in enumerate(p.pieces):
            if sp.type in (NORMAL, USER_DEFINED):
                self._id_of[sp.piece] = i
                scores.append(sp.score)
            elif sp.type == BYTE:
                self._byte_ids[_byte_value(sp.piece)] = i
        self._max_len = max((len(s) for s in self._id_of), default=1)
        min_score = min(scores, default=0.0)
        self._unk_score = min_score - _UNK_PENALTY

    # special ids (TrainerSpec defaults: unk 0, bos 1, eos 2, pad -1;
    # Gemma's proto remaps to pad 0 / eos 1 / bos 2)
    def unk_id(self) -> int:
        return self.proto.unk_id

    def bos_id(self) -> int:
        return self.proto.bos_id

    def eos_id(self) -> int:
        return self.proto.eos_id

    def pad_id(self) -> int:
        return self.proto.pad_id

    def vocab_size(self) -> int:
        return len(self.proto.pieces)

    def id_to_piece(self, i: int) -> str:
        return self.proto.pieces[i].piece

    def piece_to_id(self, piece: str) -> int:
        if piece in self._id_of:
            return self._id_of[piece]
        for i, sp in enumerate(self.proto.pieces):
            if sp.piece == piece:
                return i
        return self.proto.unk_id

    # -- normalization ------------------------------------------------------

    def _normalize(self, text: str) -> str:
        p = self.proto
        if p.remove_extra_whitespaces:
            text = " ".join(text.split())
        if p.add_dummy_prefix:
            text = " " + text
        if p.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- encode -------------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        # sentencepiece encodes empty (or whitespace-only, when
        # remove_extra_whitespaces trims it away) input to [] — the dummy
        # prefix is only added to non-empty text, so check BEFORE
        # normalization or "" would tokenize to [ws_piece_id]
        if not (text.strip() if self.proto.remove_extra_whitespaces else text):
            return []
        s = self._normalize(text)
        if not s:
            return []
        if self.proto.model_type == 2:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def _char_fallback(self, ch: str) -> tuple[list[int], float]:
        """ids + total score for a char with no piece: byte pieces when
        byte_fallback is on (sentencepiece guarantees all 256 exist then),
        else the unk id at min_score - 10."""
        if self.proto.byte_fallback and self._byte_ids:
            ids = [self._byte_ids[b] for b in ch.encode("utf-8")]
            score = sum(self.proto.pieces[i].score for i in ids)
            return ids, score
        return [self.proto.unk_id], self._unk_score

    def _encode_unigram(self, s: str) -> list[int]:
        """Viterbi max-score segmentation (unigram_model.cc's Encode)."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            upper = min(n, i + self._max_len)
            for j in range(i + 1, upper + 1):
                pid = self._id_of.get(s[i:j])
                if pid is None:
                    continue
                cand = best[i] + self.proto.pieces[pid].score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, [pid])
            # unigram_model.cc: when no single-char piece exists at i, an
            # unk/byte-fallback edge competes for the i -> i+1 span
            if s[i] not in self._id_of:
                ids, score = self._char_fallback(s[i])
                cand = best[i] + score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, ids)
        out: list[int] = []
        j = n
        while j > 0:
            i, ids = back[j]
            out[:0] = ids
            j = i
        return out

    def _encode_bpe(self, s: str) -> list[int]:
        """Merge the best-scored adjacent pair until no merge applies
        (bpe_model.cc semantics: piece score orders the merge queue)."""
        symbols = list(s)
        while len(symbols) > 1:
            best_score = float("-inf")
            best_pos = -1
            for k in range(len(symbols) - 1):
                pid = self._id_of.get(symbols[k] + symbols[k + 1])
                if pid is not None and self.proto.pieces[pid].score > best_score:
                    best_score = self.proto.pieces[pid].score
                    best_pos = k
            if best_pos < 0:
                break
            symbols[best_pos : best_pos + 2] = [
                symbols[best_pos] + symbols[best_pos + 1]
            ]
        out: list[int] = []
        for sym in symbols:
            pid = self._id_of.get(sym)
            if pid is not None:
                out.append(pid)
            else:
                out.extend(self._char_fallback(sym)[0])
        return out

    # -- decode -------------------------------------------------------------

    def decode(self, ids: Iterable[int]) -> str:
        p = self.proto
        parts: list = []  # str pieces and int bytes, in order
        for i in ids:
            sp = p.pieces[int(i)]
            if sp.type in (CONTROL, UNUSED):
                continue
            if sp.type == UNKNOWN:
                # sentencepiece renders unk as its default surface rather
                # than dropping it (DefaultUnknownSurface, " ⁇ ")
                parts.append(" ⁇ ")
                continue
            if sp.type == BYTE:
                parts.append(_byte_value(sp.piece))
            else:
                parts.append(sp.piece)
        # join, decoding byte runs as utf-8
        out = []
        run: list[int] = []
        for item in parts + [""]:
            if isinstance(item, int):
                run.append(item)
            else:
                if run:
                    out.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                out.append(item)
        text = "".join(out)
        if p.escape_whitespaces:
            text = text.replace(WS, " ")
        if p.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text


def _byte_value(piece: str) -> int:
    """``<0xNN>`` -> NN."""
    return int(piece[3:-1], 16)


def build_byte_pieces(score: float = 0.0) -> list:
    """The 256 ``<0xNN>`` BYTE pieces a byte_fallback model carries."""
    return [SentencePiece(f"<0x{b:02X}>", score, BYTE) for b in range(256)]
