"""Precompiled charsmap normalization (sentencepiece parity).

Real SentencePiece models (incl. NLLB's) normalize text with a
*precompiled charsmap*: a darts-clone double-array trie mapping source
codepoint sequences to replacement strings, serialized inside the model
proto (``NormalizerSpec.precompiled_charsmap``). This module implements:

- the blob format: ``[uint32 trie_size][trie units][replacement blob]``
  where each trie value is a byte offset into the \\0-separated
  replacement blob (sentencepiece ``normalizer.cc``),
- darts-clone unit decoding and longest-common-prefix traversal
  (XOR addressing: ``child = node ^ offset ^ byte``; unit layout
  ``offset<<10 | has_leaf<<8 | label``, leaf units ``1<<31 | value``),
- the normalization loop: longest trie match replaces the matched span,
  unmatched characters pass through,
- a small builder (``build_charsmap``) used by tests to cross-check the
  traversal against HuggingFace ``tokenizers.normalizers.Precompiled``
  (an independent implementation of the same format).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple


class DartsTrie:
    def __init__(self, units: List[int]):
        self.units = units

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def longest_match(self, data: bytes, pos: int) -> Tuple[int, int]:
        """Longest key matching data[pos:]; -> (match_len, value) or (0, -1)."""
        units = self.units
        node = 0
        unit = units[0]
        best_len, best_val = 0, -1
        for i in range(pos, len(data)):
            c = data[i]
            node ^= self._offset(unit) ^ c
            if node >= len(units):
                break
            unit = units[node]
            if (unit & 0x800000FF) != c:  # label mismatch (or leaf unit)
                break
            if (unit >> 8) & 1:  # has_leaf
                leaf = units[node ^ self._offset(unit)]
                best_len, best_val = i - pos + 1, leaf & 0x7FFFFFFF
        return best_len, best_val


class PrecompiledCharsmap:
    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack("<I", blob[:4])
        trie_blob = blob[4 : 4 + trie_size]
        self.normalized = blob[4 + trie_size :]
        units = list(struct.unpack(f"<{len(trie_blob) // 4}I", trie_blob))
        self.trie = DartsTrie(units)

    def replacement(self, value: int) -> bytes:
        end = self.normalized.index(b"\0", value)
        return self.normalized[value:end]

    def normalize(self, text: str) -> str:
        """Longest-match charsmap rewrite (sentencepiece Normalizer loop,
        granularity = one UTF-8 character when no match)."""
        data = utf8_bytes(text)
        out = bytearray()
        i, n = 0, len(data)
        while i < n:
            length, value = self.trie.longest_match(data, i)
            if length > 0:
                out += self.replacement(value)
                i += length
            else:
                # copy one UTF-8 char
                step = 1
                first = data[i]
                if first >= 0xF0:
                    step = 4
                elif first >= 0xE0:
                    step = 3
                elif first >= 0xC0:
                    step = 2
                out += data[i : i + step]
                i += step
        return out.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# Builder (tests / tooling): keys (bytes) -> values, darts-clone layout
# ---------------------------------------------------------------------------

def utf8_bytes(text: str) -> bytes:
    """UTF-8 bytes tolerant of lone surrogates (which a Python str can carry
    after surrogateescape decoding of raw data). sentencepiece operates on
    raw bytes and never crashes on invalid UTF-8, so neither may we:
    surrogateescape restores the original byte for U+DC80-DCFF escapes;
    any other unpaired surrogate (unencodable even by surrogateescape)
    degrades to '?' instead of raising."""
    try:
        return text.encode("utf-8")
    except UnicodeEncodeError:
        try:
            return text.encode("utf-8", errors="surrogateescape")
        except UnicodeEncodeError:
            return text.encode("utf-8", errors="replace")


class _TrieNode:
    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[int, "_TrieNode"] = {}
        self.value: Optional[int] = None


def _build_units(root: _TrieNode) -> List[int]:
    units: Dict[int, int] = {0: 0}
    occupied = {0}
    # Darts readers compute `pos ^ offset ^ label` for ARBITRARY query
    # labels before checking the unit's stored label — sentencepiece C++
    # and HF's Rust port do NOT bounds-check that index (the Rust port
    # panics, C++ would read out of bounds). The array must therefore
    # cover the whole 256-aligned block around every node's child base;
    # a compact `max(units)+1` sizing produced blobs that crashed HF's
    # Precompiled on non-matching lookups (caught by fuzzing).
    cover: List[int] = [0]

    def place(node: _TrieNode, pos: int):
        labels = sorted(node.children)
        slots = list(labels)
        if node.value is not None:
            slots = [0] + slots
        # find an offset where every child slot is free
        offset = 1
        while True:
            if offset >= (1 << 21):
                raise ValueError("trie too large for simple builder")
            positions = [pos ^ offset ^ c for c in slots]
            if all(p not in occupied and p > 0 for p in positions):
                break
            offset += 1
        for p in positions:
            occupied.add(p)
        has_leaf = 1 if node.value is not None else 0
        label = units.get(pos, 0) & 0xFF  # keep the label set by the parent
        units[pos] = (offset << 10) | (has_leaf << 8) | label
        cover.append(((pos ^ offset) | 0xFF))
        if node.value is not None:
            units[pos ^ offset ^ 0] = (1 << 31) | node.value
        for c in labels:
            child_pos = pos ^ offset ^ c
            units[child_pos] = c  # label; offset filled when placed
            place(node.children[c], child_pos)

    place(root, 0)
    size = max(max(units), max(cover)) + 1
    return [units.get(i, 0) for i in range(size)]


def build_charsmap(mapping: Dict[str, str]) -> bytes:
    """{source: replacement} -> precompiled charsmap blob (for tests)."""
    blob = bytearray()
    values: Dict[str, int] = {}
    for repl in dict.fromkeys(mapping.values()):
        values[repl] = len(blob)
        blob += repl.encode("utf-8") + b"\0"
    root = _TrieNode()
    for src, repl in mapping.items():
        node = root
        for b in src.encode("utf-8"):
            node = node.children.setdefault(b, _TrieNode())
        node.value = values[repl]
    units = _build_units(root)
    trie_blob = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie_blob)) + trie_blob + bytes(blob)
