"""Plain reference of the NLLB SentencePiece tokenizer (unigram model).

Written from SentencePiece's definition, in plain Python: whitespace
normalisation (extra spaces removed, a dummy prefix, spaces escaped as
"▁"), the Viterbi segmentation of highest total score over the normal
pieces (scores summed in float64, the first of equal paths kept, unknown
characters as byte pieces), NLLB's source form ``[lang] pieces [</s>]``,
and decoding (control pieces dropped, "▁" back to spaces, the dummy prefix
removed). It is given the piece table the benchmark drew, never the
program's tokenizer.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

NORMAL, CONTROL, UNKNOWN, BYTE, USER_DEFINED = 1, 3, 2, 6, 4
SPACE = "▁"
EOS = 3
UNK = 1


class Tokenizer:
    def __init__(self, pieces: Sequence[str], scores: Sequence[float], types: Sequence[int],
                 symbols: Sequence[str]):
        self.pieces = list(pieces) + list(symbols)
        self.types = list(types) + [CONTROL] * len(symbols)
        self.scores = list(scores)
        self.index: Dict[str, int] = {}
        for i, (p, t) in enumerate(zip(pieces, types)):
            if t in (NORMAL, USER_DEFINED):
                self.index.setdefault(p, i)
        self.symbol = {s: len(pieces) + j for j, s in enumerate(symbols)}
        self.bytes = {int(p[3:5], 16): i for i, (p, t) in enumerate(zip(pieces, types))
                      if t == BYTE}
        self.max_len = max(len(p) for p in self.index)
        normal = [s for s, t in zip(scores, types) if t == NORMAL]
        self.unk_score = min(normal) - 10.0

    @staticmethod
    def normalize(text: str) -> str:
        text = " ".join(w for w in text.split(" ") if w)
        return SPACE + text.replace(" ", SPACE) if text else ""

    def pieces_of(self, text: str) -> List[int]:
        s = self.normalize(text)
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back = [(0, -1)] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            found = False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                pid = self.index.get(s[i:j])
                if pid is None:
                    continue
                found = True
                cand = best[i] + self.scores[pid]
                if cand > best[j]:
                    best[j], back[j] = cand, (i, pid)
            if not found or best[i + 1] == float("-inf"):
                cand = best[i] + self.unk_score
                if cand > best[i + 1]:
                    best[i + 1], back[i + 1] = cand, (i, -1)
        ids: List[int] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            if pid == -1:
                ids.extend(reversed([self.bytes[b] for b in s[i:pos].encode("utf-8")]))
            else:
                ids.append(pid)
            pos = i
        return ids[::-1]

    def encode_source(self, text: str, lang: str) -> List[int]:
        return [self.symbol[lang]] + self.pieces_of(text) + [EOS]

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        raw = bytearray()
        for i in ids:
            t = self.types[int(i)]
            if t == BYTE:
                raw.append(int(self.pieces[int(i)][3:5], 16))
                continue
            if raw:
                out.append(raw.decode("utf-8", errors="replace"))
                raw.clear()
            if t in (CONTROL, UNKNOWN):
                continue
            out.append(self.pieces[int(i)])
        if raw:
            out.append(raw.decode("utf-8", errors="replace"))
        text = "".join(out).replace(SPACE, " ")
        return text[1:] if text.startswith(" ") else text
