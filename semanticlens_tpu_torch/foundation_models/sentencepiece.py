"""Pure-Python SentencePiece: ``.model`` protobuf parsing + encoding (a copy of
``semanticlens_tpu.foundation_models.sentencepiece``; the port imports nothing of the JAX package).

SigLIP's text tower consumes SentencePiece token ids (the reference obtains
them through open_clip → HF tokenizers; reference
semanticlens/foundation_models/clip.py:58-62). Neither the ``sentencepiece``
wheel nor any ``.model`` asset ships in this image, so this module implements
the format natively:

- :func:`parse_model` reads the standard ``sentencepiece_model.proto`` wire
  format (pieces + scores + types, trainer/normalizer specs) with no protobuf
  dependency;
- :class:`SentencePieceProcessor` encodes/decodes with the Unigram (Viterbi)
  and BPE algorithms, dummy-prefix/whitespace-escape normalization, unknown
  penalty, and byte fallback — given any stock ``.model`` file (T5/c4_en,
  mT5, Gemma, SigLIP releases) it produces the library's token ids;
- :func:`serialize_model` writes the same format, used by the tests to build
  golden models offline and available to users who want to construct small
  domain vocabularies.

Normalization approximates the library's precompiled ``nmt_nfkc`` charsmap
with :func:`unicodedata.normalize`'s NFKC plus whitespace rules — identical
for ASCII/Latin prompt text, which is what concept probing feeds it; exotic
codepoints may differ from the C++ library.
"""

from __future__ import annotations

import logging
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

WS = "▁"  # ▁ — SentencePiece's escaped whitespace

# piece types (sentencepiece_model.proto SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

# model types (TrainerSpec.ModelType)
UNIGRAM, BPE, WORD, CHAR = 1, 2, 3, 4

_UNK_PENALTY = 10.0  # kUnkPenalty in the C++ implementation


# ------------------------------------------------------------------ wire fmt
def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("malformed varint")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's bytes."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wtype == 2:  # length-delimited
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + n], pos + n
        elif wtype == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype} for field {fnum}")
        yield fnum, wtype, val


def _as_int32(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v  # negative ids arrive as 64-bit two's complement


# ------------------------------------------------------------------- parsing
@dataclass
class SpModel:
    """Parsed ``.model`` contents."""

    pieces: list[tuple[str, float, int]] = field(default_factory=list)  # (text, score, type)
    model_type: int = UNIGRAM
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    byte_fallback: bool = False
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)


def parse_model(data: bytes) -> SpModel:
    model = SpModel(pieces=[])
    for fnum, _wt, val in _iter_fields(data):
        if fnum == 1:  # SentencePiece
            text, score, ptype = "", 0.0, NORMAL
            for pf, pwt, pv in _iter_fields(val):
                if pf == 1:
                    text = pv.decode("utf-8")
                elif pf == 2 and pwt == 5:
                    score = float(np.frombuffer(pv, "<f4")[0])
                elif pf == 3:
                    ptype = pv
            model.pieces.append((text, score, ptype))
        elif fnum == 2:  # TrainerSpec
            for tf, _twt, tv in _iter_fields(val):
                if tf == 3:
                    model.model_type = tv
                elif tf == 35:
                    model.byte_fallback = bool(tv)
                elif tf == 40:
                    model.unk_id = _as_int32(tv)
                elif tf == 41:
                    model.bos_id = _as_int32(tv)
                elif tf == 42:
                    model.eos_id = _as_int32(tv)
                elif tf == 43:
                    model.pad_id = _as_int32(tv)
        elif fnum == 3:  # NormalizerSpec
            for nf, _nwt, nv in _iter_fields(val):
                if nf == 3:
                    model.add_dummy_prefix = bool(nv)
                elif nf == 4:
                    model.remove_extra_whitespaces = bool(nv)
                elif nf == 5:
                    model.escape_whitespaces = bool(nv)
    if not model.pieces:
        raise ValueError("no pieces found — not a SentencePiece .model file?")
    return model


# --------------------------------------------------------------- serializing
def _varint(n: int) -> bytes:
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | 2) + _varint(len(payload)) + payload


def _vint(fnum: int, v: int) -> bytes:
    return _varint(fnum << 3) + _varint(v)


def _f32(fnum: int, v: float) -> bytes:
    return _varint((fnum << 3) | 5) + np.float32(v).tobytes()


def serialize_model(model: SpModel) -> bytes:
    out = bytearray()
    for text, score, ptype in model.pieces:
        piece = _ld(1, text.encode("utf-8")) + _f32(2, score)
        if ptype != NORMAL:
            piece += _vint(3, ptype)
        out += _ld(1, piece)
    trainer = (
        _vint(3, model.model_type)
        + _vint(35, int(model.byte_fallback))
        + _vint(40, model.unk_id)
        + _vint(41, model.bos_id)
        + _vint(42, model.eos_id)
        + _vint(43, model.pad_id)
    )
    out += _ld(2, trainer)
    normalizer = (
        _vint(3, int(model.add_dummy_prefix))
        + _vint(4, int(model.remove_extra_whitespaces))
        + _vint(5, int(model.escape_whitespaces))
    )
    out += _ld(3, normalizer)
    return bytes(out)


# ------------------------------------------------------------------ encoding
class SentencePieceProcessor:
    """Encode/decode against a parsed :class:`SpModel`.

    Matches the C++ library's tokenization for Unigram and BPE models
    (Viterbi segmentation / score-priority merges, unknown penalty, byte
    fallback); see the module docstring for the normalization caveat.
    """

    def __init__(self, model: SpModel | bytes | str | Path):
        if isinstance(model, (str, Path)):
            model = parse_model(Path(model).read_bytes())
        elif isinstance(model, bytes):
            model = parse_model(model)
        self.model = model
        self._piece_to_id = {p: i for i, (p, _s, _t) in enumerate(model.pieces)}
        self._scores = [s for (_p, s, _t) in model.pieces]
        self._types = [t for (_p, _s, t) in model.pieces]
        self._max_piece_len = max((len(p) for (p, _s, _t) in model.pieces), default=1)
        self._min_score = min(self._scores) if self._scores else 0.0
        self._byte_ids = {}
        if model.byte_fallback:
            for i, (p, _s, t) in enumerate(model.pieces):
                if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                    self._byte_ids[int(p[3:5], 16)] = i

    # -- vocab --------------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return self.model.vocab_size

    @property
    def eos_id(self) -> int:
        return self.model.eos_id

    @property
    def pad_id(self) -> int:
        return self.model.pad_id

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.model.unk_id)

    def id_to_piece(self, idx: int) -> str:
        return self.model.pieces[idx][0]

    # -- normalization ------------------------------------------------------
    def normalize(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        if self.model.remove_extra_whitespaces:
            text = " ".join(text.split())
        if not text:
            return text
        if self.model.add_dummy_prefix:
            text = " " + text
        if self.model.escape_whitespaces:
            text = text.replace(" ", WS)
        return text

    # -- encode -------------------------------------------------------------
    def encode(self, text: str) -> list[int]:
        s = self.normalize(text)
        if not s:
            return []
        if self.model.model_type == BPE:
            return self._encode_bpe(s)
        return self._encode_unigram(s)

    def encode_as_pieces(self, text: str) -> list[str]:
        return [self.id_to_piece(i) if i != self.model.unk_id else "<unk>" for i in self.encode(text)]

    def _unknown_ids(self, ch: str) -> list[int]:
        if self.model.byte_fallback and self._byte_ids:
            return [self._byte_ids[b] for b in ch.encode("utf-8") if b in self._byte_ids]
        return [self.model.unk_id]

    def _encode_unigram(self, s: str) -> list[int]:
        n = len(s)
        unk_score = self._min_score - _UNK_PENALTY
        best = [float("-inf")] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, piece_id or -1 for unk)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            matched_single = False
            limit = min(n, i + self._max_piece_len)
            for j in range(i + 1, limit + 1):
                pid = self._piece_to_id.get(s[i:j])
                if pid is None or self._types[pid] in (CONTROL, UNUSED):
                    continue
                if j == i + 1:
                    matched_single = True
                cand = best[i] + self._scores[pid]
                if cand > best[j]:
                    best[j] = cand
                    back[j] = (i, pid)
            if not matched_single:  # cover s[i] with unk so segmentation never dead-ends
                cand = best[i] + unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, -1)
        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            ids.append((i, pid))
            j = i
        ids.reverse()
        out: list[int] = []
        for i, pid in ids:
            if pid == -1:
                # consecutive unk chars merge into one unk in the C++ impl;
                # with byte fallback each char expands to its bytes instead.
                fallback = self._unknown_ids(s[i : i + 1])
                if fallback == [self.model.unk_id] and out and out[-1] == self.model.unk_id:
                    continue
                out.extend(fallback)
            else:
                out.append(pid)
        return out

    def _encode_bpe(self, s: str) -> list[int]:
        symbols = list(s)
        while len(symbols) > 1:
            best_score, best_idx = float("-inf"), -1
            for k in range(len(symbols) - 1):
                pid = self._piece_to_id.get(symbols[k] + symbols[k + 1])
                if pid is not None and self._scores[pid] > best_score:
                    best_score, best_idx = self._scores[pid], k
            if best_idx < 0:
                break
            symbols[best_idx : best_idx + 2] = [symbols[best_idx] + symbols[best_idx + 1]]
        out: list[int] = []
        for sym in symbols:
            pid = self._piece_to_id.get(sym)
            if pid is not None:
                out.append(pid)
            else:
                out.extend(self._unknown_ids(sym) if len(sym) == 1 else
                           [i for ch in sym for i in self._unknown_ids(ch)])
        return out

    # -- decode -------------------------------------------------------------
    def decode(self, ids) -> str:
        parts = []
        for i in ids:
            i = int(i)
            if i < 0 or i >= self.vocab_size:
                continue
            text, _score, ptype = self.model.pieces[i]
            if ptype == CONTROL:
                continue
            if ptype == BYTE:
                parts.append(bytes([int(text[3:5], 16)]))
            elif ptype == UNKNOWN:
                parts.append(" ⁇ ".encode())  # the library renders unk as ⁇
            else:
                parts.append(text.encode("utf-8"))
        raw = b"".join(parts).decode("utf-8", errors="replace")
        return raw.replace(WS, " ").lstrip(" ")


class SigLipTokenizer:
    """SigLIP text framing over a SentencePiece model.

    big_vision's pp op (``tokenize(max_len, eos='sticky', pad_value=1)``)
    semantics: encode, truncate to ``context_length − 1``, always terminate
    with EOS ("sticky" — kept even after truncation), pad the remainder with
    the EOS id. For the c4_en (T5) 32k vocabulary that SigLIP ships,
    ``eos_id == pad_value == 1``.
    """

    def __init__(self, model_path: str | Path | bytes | SpModel, context_length: int = 64):
        self.sp = SentencePieceProcessor(model_path)
        self.context_length = context_length
        self.eot_token = self.sp.eos_id if self.sp.eos_id >= 0 else 1

    @property
    def vocab_size(self) -> int:
        return self.sp.vocab_size

    def encode(self, text: str) -> list[int]:
        return self.sp.encode(text)

    def __call__(self, texts, context_length: int | None = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        ctx = context_length or self.context_length
        result = np.full((len(texts), ctx), self.eot_token, np.int32)
        for i, text in enumerate(texts):
            ids = self.sp.encode(text)[: ctx - 1] + [self.eot_token]
            result[i, : len(ids)] = ids
        return result
