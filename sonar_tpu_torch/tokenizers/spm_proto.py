"""Minimal protobuf wire-format reader/writer for SentencePiece ModelProto.

The sentencepiece C++/Python libraries are not vendored in this environment;
SONAR-TPU implements the subset of the ``.model`` format it needs natively:

ModelProto (sentencepiece_model.proto):
  field 1: repeated SentencePiece pieces
      SentencePiece: 1 = piece (string), 2 = score (float),
                     3 = type (enum: 1 NORMAL, 2 UNKNOWN, 3 CONTROL,
                                4 USER_DEFINED, 5 UNUSED, 6 BYTE)
  field 2: TrainerSpec
      3 = model_type (1 UNIGRAM, 2 BPE, 3 WORD, 4 CHAR)
      35 = byte_fallback (bool)
      40/41/42/43 = unk_id / bos_id / eos_id / pad_id
  field 3: NormalizerSpec
      1 = name, 2 = precompiled_charsmap (bytes),
      3 = add_dummy_prefix, 4 = remove_extra_whitespaces,
      5 = escape_whitespaces

Only wire types 0 (varint), 1 (fixed64), 2 (length-delimited) and 5 (fixed32)
are handled; unknown fields are skipped, so real NLLB/LASER2 model files parse
fine. A writer is included to build synthetic models for tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import struct
from typing import Iterator, List, Tuple

PIECE_NORMAL = 1
PIECE_UNKNOWN = 2
PIECE_CONTROL = 3
PIECE_USER_DEFINED = 4
PIECE_UNUSED = 5
PIECE_BYTE = 6

MODEL_UNIGRAM = 1
MODEL_BPE = 2
MODEL_WORD = 3
MODEL_CHAR = 4


# ---------------------------------------------------------------------------
# Wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos : pos + 8]
            pos += 8
        elif wtype == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos : pos + length]
            pos += length
        elif wtype == 5:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _field(fnum: int, wtype: int) -> bytes:
    return _write_varint((fnum << 3) | wtype)


def _bytes_field(fnum: int, data: bytes) -> bytes:
    return _field(fnum, 2) + _write_varint(len(data)) + data


def _varint_field(fnum: int, value: int) -> bytes:
    return _field(fnum, 0) + _write_varint(value)


def _float_field(fnum: int, value: float) -> bytes:
    return _field(fnum, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# Model structures
# ---------------------------------------------------------------------------

@dataclass
class SentencePieceProto:
    piece: str
    score: float
    type: int = PIECE_NORMAL


@dataclass
class TrainerSpecProto:
    model_type: int = MODEL_UNIGRAM
    byte_fallback: bool = False
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1


@dataclass
class NormalizerSpecProto:
    name: str = "nmt_nfkc"
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True


@dataclass
class ModelProto:
    pieces: List[SentencePieceProto] = field(default_factory=list)
    trainer: TrainerSpecProto = field(default_factory=TrainerSpecProto)
    normalizer: NormalizerSpecProto = field(default_factory=NormalizerSpecProto)


def _parse_piece(buf: bytes) -> SentencePieceProto:
    piece, score, ptype = "", 0.0, PIECE_NORMAL
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            piece = val.decode("utf-8")
        elif fnum == 2 and wtype == 5:
            score = struct.unpack("<f", val)[0]
        elif fnum == 3 and wtype == 0:
            ptype = int(val)
    return SentencePieceProto(piece, score, ptype)


def _parse_trainer(buf: bytes) -> TrainerSpecProto:
    spec = TrainerSpecProto()
    for fnum, wtype, val in _iter_fields(buf):
        if wtype != 0:
            continue
        v = int(val)
        if fnum == 3:
            spec.model_type = v
        elif fnum == 35:
            spec.byte_fallback = bool(v)
        elif fnum == 40:
            spec.unk_id = _zigzag_if_negative(v)
        elif fnum == 41:
            spec.bos_id = _zigzag_if_negative(v)
        elif fnum == 42:
            spec.eos_id = _zigzag_if_negative(v)
        elif fnum == 43:
            spec.pad_id = _zigzag_if_negative(v)
    return spec


def _zigzag_if_negative(v: int) -> int:
    """proto int32 negatives arrive as 10-byte two's-complement varints."""
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def _parse_normalizer(buf: bytes) -> NormalizerSpecProto:
    spec = NormalizerSpecProto()
    for fnum, wtype, val in _iter_fields(buf):
        if fnum == 1 and wtype == 2:
            spec.name = val.decode("utf-8")
        elif fnum == 2 and wtype == 2:
            spec.precompiled_charsmap = bytes(val)
        elif fnum == 3 and wtype == 0:
            spec.add_dummy_prefix = bool(val)
        elif fnum == 4 and wtype == 0:
            spec.remove_extra_whitespaces = bool(val)
        elif fnum == 5 and wtype == 0:
            spec.escape_whitespaces = bool(val)
    return spec


def parse_model_proto(data: bytes) -> ModelProto:
    model = ModelProto()
    for fnum, wtype, val in _iter_fields(data):
        if fnum == 1 and wtype == 2:
            model.pieces.append(_parse_piece(val))
        elif fnum == 2 and wtype == 2:
            model.trainer = _parse_trainer(val)
        elif fnum == 3 and wtype == 2:
            model.normalizer = _parse_normalizer(val)
    return model


def serialize_model_proto(model: ModelProto) -> bytes:
    """Writer used to build synthetic .model files for tests."""
    out = bytearray()
    for p in model.pieces:
        body = (
            _bytes_field(1, p.piece.encode("utf-8"))
            + _float_field(2, p.score)
            + _varint_field(3, p.type)
        )
        out += _bytes_field(1, body)
    t = model.trainer
    tbody = (
        _varint_field(3, t.model_type)
        + _varint_field(35, 1 if t.byte_fallback else 0)
        + _varint_field(40, t.unk_id & ((1 << 64) - 1))
        + _varint_field(41, t.bos_id & ((1 << 64) - 1))
        + _varint_field(42, t.eos_id & ((1 << 64) - 1))
        + _varint_field(43, t.pad_id & ((1 << 64) - 1))
    )
    out += _bytes_field(2, tbody)
    n = model.normalizer
    nbody = (
        _bytes_field(1, n.name.encode("utf-8"))
        + _bytes_field(2, n.precompiled_charsmap)
        + _varint_field(3, 1 if n.add_dummy_prefix else 0)
        + _varint_field(4, 1 if n.remove_extra_whitespaces else 0)
        + _varint_field(5, 1 if n.escape_whitespaces else 0)
    )
    out += _bytes_field(3, nbody)
    return bytes(out)
