"""NLLB tokenizer for the port.

Same conventions as ``sonar_tpu.tokenizers.nllb.NllbTokenizer`` (source
encoding ``[<lang>] pieces [</s>]``, target ``[</s>, <lang>] pieces [</s>]``),
built on the port's copy of the SentencePiece model
(``sonar_tpu_torch.tokenizers.spm``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

from sonar_tpu_torch.tokenizers.spm import (
    SentencePieceDecoder,
    SentencePieceEncoder,
    SentencePieceModel,
    vocab_info_from_sentencepiece,
)


class NllbTokenizer:
    def __init__(
        self,
        model: Union[str, Path, SentencePieceModel],
        langs: Sequence[str],
        default_lang: Optional[str] = None,
    ):
        if isinstance(model, SentencePieceModel):
            # Model must already contain the language symbols.
            self.model = model
            missing = [l for l in langs if l not in model._index]
            if missing:
                raise ValueError(f"model lacks language symbols: {missing[:3]}...")
        else:
            self.model = SentencePieceModel(model, list(langs) + ["<MINED_DATA>"])
        self.langs = list(langs)
        self.default_lang = default_lang or (langs[0] if langs else None)
        self.vocab_info = vocab_info_from_sentencepiece(self.model)

    def create_encoder(
        self,
        lang: Optional[str] = None,
        mode: str = "source",
    ) -> SentencePieceEncoder:
        lang = lang or self.default_lang
        if lang is None:
            raise ValueError("a language must be specified")
        if self.langs and lang not in self.langs:
            raise ValueError(
                f"'{lang}' is not a supported language (expected one of "
                f"{len(self.langs)} FLORES codes, e.g. {self.langs[:3]})"
            )
        if mode in ("source", "default"):
            return SentencePieceEncoder(
                self.model, prefix_tokens=[lang], suffix_tokens=["</s>"]
            )
        if mode == "target":
            return SentencePieceEncoder(
                self.model, prefix_tokens=["</s>", lang], suffix_tokens=["</s>"]
            )
        raise ValueError(f"unknown mode: {mode}")

    def create_raw_encoder(self) -> SentencePieceEncoder:
        return SentencePieceEncoder(self.model)

    def create_decoder(self) -> SentencePieceDecoder:
        return SentencePieceDecoder(self.model)

    def lang_token_id(self, lang: str) -> int:
        return self.model.piece_to_id(lang)

    def decode(self, ids: Sequence[int]) -> str:
        return self.model.decode(ids)
