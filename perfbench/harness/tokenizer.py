"""The synthetic NLLB-scale SentencePiece model the text cells tokenize with.

No published tokenizer is in the repository, so the benchmark draws one of
NLLB's size from the seed: ``vocab_size - 203`` unigram pieces (4 specials,
the letters and "▁", word pieces, other pieces, 256 byte pieces), then 202
language codes and ``<MINED_DATA>`` appended as control symbols, which is
NLLB's 256,206 for the ``basic`` models. The traffic writes its sentences
with the word pieces ("▁" + 2-9 letters, scores in (-1.9, -1.0)); every
other piece scores -2 or lower, so a word is always one piece and a
sentence of n words is n + 2 tokens with its language code and EOS.

The normalizer is "identity" (whitespace only), which the port runs in its
native tokenizer as it runs a published model's precompiled charsmap; the
default "nmt_nfkc" name without a charsmap would add a Python NFKC pass per
sentence that no published model pays.

``Pieces`` is plain data: the program's tokenizer is built from it
(``program_tokenizer``) and so is the plain reference's
(``perfbench/reference/spm.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

N_LANGS = 202
ENG = "eng_Latn"
NORMAL, UNKNOWN, CONTROL, BYTE = 1, 2, 3, 6  # SentencePiece piece types
LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))
WORD_SHARE = 0.5  # of the pieces that are neither special, letter nor byte


@dataclass
class Pieces:
    pieces: List[str]
    scores: List[float]          # float32 values, as a model file stores them
    types: List[int]
    symbols: List[str]           # control symbols appended after the pieces
    words: List[str]             # the word pieces' words (without "▁")

    @property
    def vocab_size(self) -> int:
        return len(self.pieces) + len(self.symbols)


def languages() -> List[str]:
    return [f"lng{i:03d}_Latn" for i in range(N_LANGS - 1)] + [ENG]


def _strings(rng: np.random.Generator, n: int, taken: set) -> List[str]:
    out: List[str] = []
    while len(out) < n:
        k = 2 * (n - len(out)) + 64
        lens = rng.integers(2, 10, k)
        chars = LETTERS[rng.integers(0, 26, int(lens.sum()))]
        ends = np.cumsum(lens)
        flat = "".join(chars.tolist())
        for start, end in zip(ends - lens, ends):
            s = flat[start:end]
            if s not in taken:
                taken.add(s)
                out.append(s)
                if len(out) == n:
                    break
    return out


def draw(seed: int, vocab_size: int) -> Pieces:
    rng = np.random.default_rng([seed, 1])
    specials = [("<blank>", CONTROL), ("<unk>", UNKNOWN), ("<s>", CONTROL), ("</s>", CONTROL)]
    pieces = [p for p, _ in specials]
    types = [t for _, t in specials]
    scores = [0.0] * 4
    singles = list("abcdefghijklmnopqrstuvwxyz") + ["▁"]
    pieces += singles
    types += [NORMAL] * len(singles)
    scores += [-10.0] * len(singles)
    n_rest = vocab_size - N_LANGS - 1 - len(pieces) - 256
    n_words = int(n_rest * WORD_SHARE)
    taken: set = set(singles)
    words = _strings(rng, n_words, taken)
    others = _strings(rng, n_rest - n_words, taken)
    word_scores = -rng.uniform(1.0, 1.9, n_words).astype(np.float32)
    other_scores = -rng.uniform(2.0, 13.0, len(others)).astype(np.float32)
    pieces += ["▁" + w for w in words] + others
    types += [NORMAL] * n_rest
    scores += [float(s) for s in word_scores] + [float(s) for s in other_scores]
    pieces += [f"<0x{b:02X}>" for b in range(256)]
    types += [BYTE] * 256
    scores += [-20.0] * 256
    return Pieces(pieces, scores, types, languages() + ["<MINED_DATA>"], words)


def program_tokenizer(p: Pieces) -> Any:
    """The port's ``NllbTokenizer`` over ``p`` (unk 1, bos 2, eos 3, pad 1)."""
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
    from sonar_tpu_torch.tokenizers.spm import SentencePieceModel
    from sonar_tpu_torch.tokenizers.spm_proto import (
        ModelProto,
        NormalizerSpecProto,
        SentencePieceProto,
        TrainerSpecProto,
    )

    proto = ModelProto(
        pieces=[SentencePieceProto(s, sc, t) for s, sc, t in zip(p.pieces, p.scores, p.types)],
        trainer=TrainerSpecProto(unk_id=1, bos_id=2, eos_id=3, pad_id=1, byte_fallback=True),
        normalizer=NormalizerSpecProto(name="identity"),
    )
    langs = p.symbols[:-1]
    return NllbTokenizer(SentencePieceModel(proto, p.symbols), langs, default_lang=ENG)
