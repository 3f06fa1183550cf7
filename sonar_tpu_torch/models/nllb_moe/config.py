"""NLLB-200 MoE configuration and arch registry.

``nllb_moe_54b`` holds the published values of ``facebook/nllb-moe-54b``
(HF ``NllbMoeConfig``; fairseq's transformer with ``moe_freq 4``): 24 + 24
pre-LN layers of D 2,048, 16 heads of 128, ReLU FFNs of 8,192 with biases;
every 4th layer of each stack sparse ((i + 1) % 4 == 0), 128 experts of
the dense FFN's shape, top-2 routing in fp32; the 256,206-piece NLLB
vocabulary in one table tied between the encoder, the decoder and the
output projection; embeddings scaled by sqrt(D); fairseq sinusoidal
positions (1,024, after the pad offset); a final LayerNorm a stack.

``experts_held`` is the contiguous range [first, end) of expert ids whose
weights this card keeps: the whole range on one card, 16 of 128 on one of
eight expert-parallel cards.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

from sonar_tpu_torch.models.common import ConfigRegistry, VocabularyInfo
from sonar_tpu_torch.models.sonar_text.config import NLLB_VOCAB


@dataclass(frozen=True)
class NllbMoeConfig:
    model_dim: int
    num_encoder_layers: int
    num_decoder_layers: int
    num_encoder_attn_heads: int
    num_decoder_attn_heads: int
    ffn_inner_dim: int
    num_experts: int
    encoder_sparse_step: int
    decoder_sparse_step: int
    vocab_info: VocabularyInfo
    max_seq_len: int = 1024
    experts_held: Tuple[int, int] = (0, 0)  # (0, 0): every expert
    activation_fn: str = "relu"

    @property
    def held(self) -> Tuple[int, int]:
        """[first, end) of the experts this card keeps."""
        return self.experts_held if self.experts_held != (0, 0) else (0, self.num_experts)

    def holding(self, first: int, end: int) -> "NllbMoeConfig":
        """This config with the experts [first, end) held."""
        if not 0 <= first < end <= self.num_experts:
            raise ValueError(f"experts [{first}, {end}) outside 0..{self.num_experts}")
        return dataclasses.replace(self, experts_held=(first, end))


nllb_moe_archs: ConfigRegistry[NllbMoeConfig] = ConfigRegistry("nllb_moe")


@nllb_moe_archs.arch("nllb_moe_54b")
def _nllb_moe_54b() -> NllbMoeConfig:
    return NllbMoeConfig(
        model_dim=2048, num_encoder_layers=24, num_decoder_layers=24,
        num_encoder_attn_heads=16, num_decoder_attn_heads=16, ffn_inner_dim=8192,
        num_experts=128, encoder_sparse_step=4, decoder_sparse_step=4, vocab_info=NLLB_VOCAB,
    )


@nllb_moe_archs.arch("toy")
def _toy() -> NllbMoeConfig:
    return NllbMoeConfig(
        model_dim=64, num_encoder_layers=4, num_decoder_layers=4,
        num_encoder_attn_heads=4, num_decoder_attn_heads=4, ffn_inner_dim=128,
        num_experts=8, encoder_sparse_step=2, decoder_sparse_step=2,
        vocab_info=VocabularyInfo(size=1024, unk_idx=1, bos_idx=2, eos_idx=3, pad_idx=1),
        max_seq_len=128,
    )
