"""Native SentencePiece: unigram Viterbi encoding + decoding, no C++ deps.

Replaces fairseq2n's C++ ``SentencePieceModel/Encoder/Decoder`` (used by the
reference at ``sonar/inference_pipelines/text.py:13-14`` via the tokenizer
hub and at ``sonar/models/laser2_text/tokenizer.py:16-21``).

Implemented:
- ``.model`` protobuf parsing (see ``spm_proto``),
- NMT/NFKC-style text normalization (unicodedata NFKC + NMT space rules;
  the precompiled charsmap is very close to NFKC for practical text — any
  divergence only affects exotic codepoints),
- whitespace escaping to U+2581 with optional dummy prefix,
- unigram-LM Viterbi segmentation with byte-fallback and UNK penalty
  (same algorithm as sentencepiece's ``UnigramModel::Encode``),
- true BPE merge encoding for BPE-type models (score-priority agenda over
  adjacent pairs, leftmost-first ties — sentencepiece ``BpeModel::Encode``
  semantics),
- control-symbol extension (fairseq2 ``SentencePieceModel(path, symbols)``).

A C++ core (``sonar_tpu_torch/native``) accelerates batch encoding when built; this
module is the always-available pure-Python reference implementation.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union
import unicodedata

from sonar_tpu_torch.tokenizers.charsmap import utf8_bytes
from sonar_tpu_torch.tokenizers.spm_proto import (
    MODEL_BPE,
    MODEL_UNIGRAM,
    PIECE_BYTE,
    PIECE_CONTROL,
    PIECE_NORMAL,
    PIECE_UNKNOWN,
    PIECE_USER_DEFINED,
    ModelProto,
    parse_model_proto,
)

SPACE_ESCAPE = "▁"  # ▁
UNK_PENALTY = 10.0


class SentencePieceModel:
    """SentencePiece model with optional appended control symbols."""

    def __init__(
        self,
        path_or_proto: Union[str, Path, bytes, ModelProto],
        control_symbols: Optional[Sequence[str]] = None,
    ):
        if isinstance(path_or_proto, ModelProto):
            proto = path_or_proto
        elif isinstance(path_or_proto, bytes):
            proto = parse_model_proto(path_or_proto)
        else:
            proto = parse_model_proto(Path(path_or_proto).read_bytes())
        self.proto = proto

        self._pieces: List[str] = [p.piece for p in proto.pieces]
        self._scores: List[float] = [p.score for p in proto.pieces]
        self._types: List[int] = [p.type for p in proto.pieces]
        self._index: Dict[str, int] = {}
        for i, p in enumerate(proto.pieces):
            self._index.setdefault(p.piece, i)

        if control_symbols:
            for sym in control_symbols:
                if sym in self._index:
                    # Already a vocab piece (e.g. a .model that ships its
                    # language codes): reuse its id. Appending a duplicate
                    # row would inflate len(model) past the checkpoint's
                    # embedding table while the id stayed the old one.
                    continue
                self._pieces.append(sym)
                self._scores.append(0.0)
                self._types.append(PIECE_CONTROL)
                self._index[sym] = len(self._pieces) - 1

        # Special ids: trainer spec is authoritative; fall back to piece types.
        t = proto.trainer
        self.unk_idx = self._resolve_special(t.unk_id, PIECE_UNKNOWN)
        self.bos_idx = self._resolve_special(t.bos_id, None, "<s>")
        self.eos_idx = self._resolve_special(t.eos_id, None, "</s>")
        self.pad_idx = self._resolve_special(t.pad_id, None, "<pad>")

        # Byte-fallback table.
        self._byte_ids: Dict[int, int] = {}
        for i, (piece, ptype) in enumerate(zip(self._pieces, self._types)):
            if ptype == PIECE_BYTE and len(piece) == 6 and piece.startswith("<0x"):
                self._byte_ids[int(piece[3:5], 16)] = i
        self.byte_fallback = bool(t.byte_fallback) and bool(self._byte_ids)

        # Viterbi lookup structures over *encodable* pieces only.
        self._seg_index: Dict[str, int] = {
            p: i
            for p, i in self._index.items()
            if self._types[i] in (PIECE_NORMAL, PIECE_USER_DEFINED)
        }
        self._max_piece_len = max((len(p) for p in self._seg_index), default=1)
        scores = [s for i, s in enumerate(self._scores) if self._types[i] == PIECE_NORMAL]
        self._min_score = min(scores, default=0.0)
        self._unk_score = self._min_score - UNK_PENALTY
        self.model_type = t.model_type
        self._native = None
        self._native_failed = False

    def _resolve_special(self, declared: int, ptype, piece: str = "") -> Optional[int]:
        if declared is not None and declared >= 0:
            return declared
        if ptype is not None:
            for i, p in enumerate(self.proto.pieces):
                if p.type == ptype:
                    return i
        if piece and piece in self._index:
            return self._index[piece]
        return None

    # -- basic accessors ----------------------------------------------------

    def __len__(self) -> int:
        return len(self._pieces)

    @property
    def vocabulary_size(self) -> int:
        return len(self._pieces)

    def piece_to_id(self, piece: str) -> int:
        idx = self._index.get(piece)
        if idx is None:
            if self.unk_idx is None:
                raise KeyError(piece)
            return self.unk_idx
        return idx

    def id_to_piece(self, idx: int) -> str:
        return self._pieces[idx]

    # -- normalization ------------------------------------------------------

    def normalize(self, text: str) -> str:
        n = self.proto.normalizer
        if n.precompiled_charsmap:
            # Exact sentencepiece normalization: the model's own precompiled
            # charsmap (darts-clone trie), as used by real NLLB/LASER models.
            if not hasattr(self, "_charsmap"):
                from sonar_tpu_torch.tokenizers.charsmap import PrecompiledCharsmap

                self._charsmap = PrecompiledCharsmap(n.precompiled_charsmap)
            text = self._charsmap.normalize(text)
        elif n.name != "identity":
            # NMT rules first, then NFKC — sentencepiece's nmt_nfkc order,
            # exact tables per its builder (mirrored by HF tokenizers'
            # `normalizers.Nmt`, the executable oracle in
            # tests/unit/test_tokenizer_fuzz_multiscript.py): control chars
            # removed; tab/newline/exotic separators/zero-widths -> space.
            out = []
            for ch in text:
                cp = ord(ch)
                if (
                    0x0001 <= cp <= 0x0008
                    or cp == 0x000B
                    or 0x000E <= cp <= 0x001F
                    or cp in (0x007F, 0x008F, 0x009F)
                ):
                    continue
                if (
                    cp in (0x0009, 0x000A, 0x000C, 0x000D, 0x1680)
                    or 0x200B <= cp <= 0x200F
                    or cp in (0x2028, 0x2029, 0x2581, 0xFEFF, 0xFFFD)
                ):
                    out.append(" ")
                else:
                    out.append(ch)
            text = unicodedata.normalize("NFKC", "".join(out))
        if n.remove_extra_whitespaces:
            text = " ".join(x for x in text.split(" ") if x)
        if not text:
            return text
        if n.add_dummy_prefix:
            text = " " + text
        if n.escape_whitespaces:
            text = text.replace(" ", SPACE_ESCAPE)
        return text

    # -- encoding -----------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        """Text -> piece ids (no prefix/suffix handling; see encoders)."""
        s = self.normalize(text)
        if not s:
            return []
        if self.model_type == MODEL_UNIGRAM:
            native = self._native_encoder()
            if native is not None:
                try:
                    return native.encode_normalized(s)
                except UnicodeEncodeError:
                    # Lone surrogates (surrogateescape'd input) cannot cross
                    # the UTF-8 ABI; the pure-Python DP handles them.
                    pass
            return self._viterbi(s)
        if self.model_type == MODEL_BPE:
            return self._bpe_encode(s)
        return self._longest_match(s)

    def _native_encoder(self):
        """C++ Viterbi core (sonar_tpu_torch/native); falls back to Python."""
        if self._native is not None or self._native_failed:
            return self._native
        try:
            from sonar_tpu_torch.native import NativeSpmEncoder

            items = sorted(self._seg_index.items(), key=lambda kv: kv[1])
            native = NativeSpmEncoder(
                pieces=[p for p, _ in items],
                ids=[i for _, i in items],
                scores=[self._scores[i] for _, i in items],
                unk_id=self.unk_idx if self.unk_idx is not None else 0,
                unk_score=self._unk_score,
                byte_ids=self._byte_ids if self.byte_fallback else {},
            )
            # Install the normalizer eagerly: doing it lazily from
            # encode_batch would race — another thread could be inside a
            # GIL-released native encode while the C++ normalizer tables
            # are being (re)assigned.
            n = self.proto.normalizer
            if n.precompiled_charsmap or n.name == "identity":
                native.set_normalizer(
                    n.precompiled_charsmap,
                    n.remove_extra_whitespaces,
                    n.add_dummy_prefix,
                    n.escape_whitespaces,
                )
            self._native = native
        except Exception:
            self._native_failed = True
        return self._native

    def encode_batch(
        self, texts: Sequence[str], num_threads: Optional[int] = None
    ) -> List[List[int]]:
        """Tokenize many strings at once (list of id lists, order preserved).

        Fast path (unigram models with the C++ core built): ONE native call
        per batch — normalization (the model's precompiled charsmap, or the
        identity normalizer's whitespace phase) + trie Viterbi run inside an
        internal thread pool with the GIL released. Models that need the
        NFKC fallback (no charsmap) normalize per string in Python, then
        batch-Viterbi natively. Bit-identical to ``[self.encode(t) for t in
        texts]`` in every mode (fuzz-asserted in tests/unit/test_native.py).
        """
        if num_threads is None:
            import os

            num_threads = int(
                os.environ.get("SONAR_TPU_TOKENIZE_THREADS", 0)
            ) or min(8, os.cpu_count() or 1)
        texts = list(texts)
        if self.model_type == MODEL_UNIGRAM and len(texts) > 1:
            native = self._native_encoder()
            if native is not None:
                pre_normalized = not native.normalizer_set
                source = (
                    (self.normalize(t) for t in texts)
                    if pre_normalized
                    else texts
                )
                # Single UTF-8 pass; lone surrogates (surrogateescape'd
                # input) cannot cross the UTF-8 ABI — route those few
                # through the Python DP and keep the rest on the batch path.
                blobs, bad = [], {}
                for i, t in enumerate(source):
                    try:
                        blobs.append(t.encode("utf-8"))
                    except UnicodeEncodeError:
                        blobs.append(b"")
                        bad[i] = texts[i]
                out = native.encode_batch_blobs(
                    blobs,
                    pre_normalized=pre_normalized,
                    num_threads=num_threads,
                )
                for i, t in bad.items():
                    s = self.normalize(t)
                    out[i] = self._viterbi(s) if s else []
                return out
        return [self.encode(t) for t in texts]

    def encode_as_pieces(self, text: str) -> List[str]:
        return [self._pieces[i] for i in self.encode(text)]

    def _viterbi(self, s: str) -> List[int]:
        n = len(s)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[tuple]] = [None] * (n + 1)
        best[0] = 0.0
        index = self._seg_index
        scores = self._scores
        max_len = self._max_piece_len
        for i in range(n):
            bi = best[i]
            if bi <= NEG:
                continue
            hi = min(n, i + max_len)
            sub = s[i:hi]
            found = False
            for L in range(1, hi - i + 1):
                pid = index.get(sub[:L])
                if pid is None:
                    continue
                found = True
                cand = bi + scores[pid]
                if cand > best[i + L]:
                    best[i + L] = cand
                    back[i + L] = (i, pid)
            if not found or best[i + 1] <= NEG:
                # single-char fallback: unk (or bytes at decode stage)
                cand = bi + self._unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = (i, -1)
        # Backtrack.
        ids: List[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            if pid == -1:
                ids.extend(reversed(self._fallback_ids(s[i:pos])))
            else:
                ids.append(pid)
            pos = i
        ids.reverse()
        return ids

    def _fallback_ids(self, chunk: str) -> List[int]:
        if self.byte_fallback:
            # utf8_bytes: a lone surrogate must byte-fall-back to its raw
            # byte (surrogateescape) rather than crash the encode.
            return [self._byte_ids[b] for b in utf8_bytes(chunk)]
        return [self.unk_idx if self.unk_idx is not None else 0]

    def _bpe_encode(self, s: str) -> List[int]:
        """SentencePiece BPE: repeatedly merge the adjacent symbol pair whose
        concatenation is a vocab piece with the highest score (piece scores
        encode merge priority, typically -rank); ties resolve to the
        leftmost pair. sentencepiece ``BpeModel::Encode`` semantics.
        Symbols that end un-merged and are not vocab pieces fall back to
        bytes/unk like the unigram path.
        """
        import heapq

        sym: List[Optional[str]] = list(s)
        n = len(sym)
        if n == 0:
            return []
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(0, n - 1))
        rev = [0] * n  # bump on merge to invalidate stale heap entries
        heap: List[tuple] = []

        def push(i: int) -> None:
            if i < 0:
                return
            j = nxt[i]
            if j < 0 or sym[i] is None or sym[j] is None:
                return
            pid = self._seg_index.get(sym[i] + sym[j])
            if pid is not None:
                heapq.heappush(
                    heap, (-self._scores[pid], i, rev[i], rev[j], pid)
                )

        for i in range(n - 1):
            push(i)
        while heap:
            _, i, ri, rj, pid = heapq.heappop(heap)
            if sym[i] is None or ri != rev[i]:
                continue
            j = nxt[i]
            if j < 0 or sym[j] is None or rj != rev[j]:
                continue
            sym[i] = sym[i] + sym[j]
            rev[i] += 1
            sym[j] = None
            nxt[i] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = i
            push(prv[i])
            push(i)

        ids: List[int] = []
        i = 0
        while i >= 0:
            piece = sym[i]
            if piece is not None:
                pid = self._seg_index.get(piece)
                if pid is not None:
                    ids.append(pid)
                else:
                    ids.extend(self._fallback_ids(piece))
            i = nxt[i]
        return ids

    def _longest_match(self, s: str) -> List[int]:
        ids: List[int] = []
        i, n = 0, len(s)
        while i < n:
            matched = None
            for L in range(min(self._max_piece_len, n - i), 0, -1):
                pid = self._seg_index.get(s[i : i + L])
                if pid is not None:
                    matched = (L, pid)
                    break
            if matched is None:
                ids.extend(self._fallback_ids(s[i]))
                i += 1
            else:
                ids.append(matched[1])
                i += matched[0]
        return ids

    # -- decoding -----------------------------------------------------------

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush_bytes():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for idx in ids:
            idx = int(idx)
            if idx < 0 or idx >= len(self._pieces):
                continue
            ptype = self._types[idx]
            if ptype == PIECE_BYTE:
                byte_buf.append(int(self._pieces[idx][3:5], 16))
                continue
            flush_bytes()
            if ptype in (PIECE_CONTROL, PIECE_UNKNOWN):
                continue
            out.append(self._pieces[idx])
        flush_bytes()
        text = "".join(out).replace(SPACE_ESCAPE, " ")
        return text[1:] if text.startswith(" ") else text


class SentencePieceEncoder:
    """Callable encoder with prefix/suffix token handling (fairseq2 parity)."""

    def __init__(
        self,
        model: SentencePieceModel,
        prefix_tokens: Optional[Sequence[str]] = None,
        suffix_tokens: Optional[Sequence[str]] = None,
    ):
        self.model = model
        self.prefix_indices = [model.piece_to_id(t) for t in (prefix_tokens or [])]
        self.suffix_indices = [model.piece_to_id(t) for t in (suffix_tokens or [])]

    def __call__(self, text: str) -> List[int]:
        return self.prefix_indices + self.model.encode(text) + self.suffix_indices

    def encode_batch(
        self, texts: Sequence[str], num_threads: Optional[int] = None
    ) -> List[List[int]]:
        """Batched tokenization through the native fast path (one
        GIL-releasing call; see ``SentencePieceModel.encode_batch``)."""
        pre, suf = self.prefix_indices, self.suffix_indices
        ids = self.model.encode_batch(texts, num_threads=num_threads)
        if not pre and not suf:
            return ids
        return [pre + x + suf for x in ids]


class SentencePieceDecoder:
    def __init__(self, model: SentencePieceModel):
        self.model = model

    def __call__(self, ids: Sequence[int]) -> str:
        return self.model.decode(ids)


def vocab_info_from_sentencepiece(model: SentencePieceModel) -> Any:
    from sonar_tpu_torch.models.common import VocabularyInfo

    return VocabularyInfo(
        size=len(model),
        unk_idx=model.unk_idx,
        bos_idx=model.bos_idx,
        eos_idx=model.eos_idx,
        pad_idx=model.pad_idx if model.pad_idx is not None else model.unk_idx,
    )
