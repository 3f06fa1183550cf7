"""LASER2 tokenizer: SentencePiece + fairseq-dictionary id offset.

The port's copy of ``sonar_tpu.tokenizers.laser2``, on the port's own
SentencePiece (``tokenizers.spm``): the SPM model is loaded with an extra
``<pad>`` control symbol, sentences get a ``</s>`` suffix, and — the
id-offset hack — every SPM id >= 3 is shifted by +4 to account for the
fairseq dictionary specials the LASER2 LSTM was trained with.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Union

from sonar_tpu_torch.models.common import VocabularyInfo
from sonar_tpu_torch.tokenizers.spm import (
    SentencePieceDecoder,
    SentencePieceEncoder,
    SentencePieceModel,
)


class Laser2Encoder:
    def __init__(self, spm_encoder: SentencePieceEncoder):
        self.spm_encoder = spm_encoder

    def __call__(self, text: str) -> List[int]:
        return [i + 4 if i >= 3 else i for i in self.spm_encoder(text)]


class Laser2Tokenizer:
    def __init__(self, model: Union[str, Path, SentencePieceModel]):
        if isinstance(model, SentencePieceModel):
            self.model = model
        else:
            self.model = SentencePieceModel(model, ["<pad>"])
        m = self.model
        self.vocab_info = VocabularyInfo(
            size=len(m) + 4,  # ids >= 3 are shifted by 4
            unk_idx=m.unk_idx,
            bos_idx=m.bos_idx,
            eos_idx=m.eos_idx,
            pad_idx=m.pad_idx if m.pad_idx is not None else m.unk_idx,
        )

    def create_encoder(self, **_ignored: Any) -> Laser2Encoder:
        return Laser2Encoder(
            SentencePieceEncoder(self.model, suffix_tokens=["</s>"])
        )

    def create_raw_encoder(self) -> SentencePieceEncoder:
        return SentencePieceEncoder(self.model)

    def create_decoder(self) -> SentencePieceDecoder:
        return SentencePieceDecoder(self.model)
