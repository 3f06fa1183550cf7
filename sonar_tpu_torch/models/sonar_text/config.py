"""SONAR text encoder and decoder configs + arch registries.

Field-for-field copy of ``sonar_tpu.models.sonar_text.config``; the
``basic``, ``small`` and ``toy`` archs of both registries hold identical
values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from sonar_tpu_torch.models.common import ConfigRegistry, VocabularyInfo

NLLB_VOCAB = VocabularyInfo(size=256206, unk_idx=1, bos_idx=2, eos_idx=3, pad_idx=1)
_SMALL_VOCAB = VocabularyInfo(size=32005, unk_idx=1, bos_idx=2, eos_idx=3, pad_idx=1)
_TOY_VOCAB = VocabularyInfo(size=1024, unk_idx=1, bos_idx=2, eos_idx=3, pad_idx=1)


@dataclass
class SonarTextEncoderConfig:
    model_dim: int
    max_seq_len: int
    vocab_info: VocabularyInfo
    num_encoder_layers: int
    num_decoder_layers: int
    num_encoder_attn_heads: int
    num_decoder_attn_heads: int
    ffn_inner_dim: int
    pooling: str
    embedding_dim: Optional[int] = None
    decoder_ffn_inner_dim: Optional[int] = None
    activation_fn: str = "relu"
    layernorm_embedding: bool = False
    no_scale_embedding: bool = False
    no_token_positional_embeddings: bool = False
    learned_pos: bool = False
    emb_dropout_p: float = 0.1
    attention_dropout_p: float = 0.1
    activation_dropout_p: float = 0.1
    normalize_before: bool = False
    _from_fairseq: bool = False


@dataclass
class SonarTextDecoderConfig:
    model_dim: int
    max_seq_len: int
    vocab_info: VocabularyInfo
    activation_fn: str = "relu"
    layernorm_embedding: bool = False
    no_scale_embedding: bool = False
    no_token_positional_embeddings: bool = False
    learned_pos: bool = False
    emb_dropout_p: float = 0.1
    attention_dropout_p: float = 0.1
    activation_dropout_p: float = 0.1
    normalize_before: bool = True
    num_encoder_layers: int = 24
    num_decoder_layers: int = 24
    num_encoder_attn_heads: int = 16
    num_decoder_attn_heads: int = 16
    ffn_inner_dim: int = 1024 * 8
    input_dim: Optional[int] = None


sonar_text_encoder_archs: ConfigRegistry[SonarTextEncoderConfig] = ConfigRegistry(
    "sonar_text_encoder"
)
sonar_text_decoder_archs: ConfigRegistry[SonarTextDecoderConfig] = ConfigRegistry(
    "sonar_text_decoder"
)


@sonar_text_encoder_archs.arch("basic")
def _encoder_basic() -> SonarTextEncoderConfig:
    return SonarTextEncoderConfig(
        model_dim=1024,
        max_seq_len=512,
        vocab_info=NLLB_VOCAB,
        num_encoder_layers=24,
        num_decoder_layers=24,
        num_encoder_attn_heads=16,
        num_decoder_attn_heads=16,
        ffn_inner_dim=1024 * 8,
        pooling="mean",
        _from_fairseq=True,
    )


@sonar_text_encoder_archs.arch("small")
def _encoder_small() -> SonarTextEncoderConfig:
    cfg = _encoder_basic()
    return dataclasses.replace(
        cfg,
        vocab_info=_SMALL_VOCAB,
        num_encoder_layers=6,
        num_decoder_layers=6,
        ffn_inner_dim=1024 * 4,
    )


@sonar_text_encoder_archs.arch("toy")
def _encoder_toy() -> SonarTextEncoderConfig:
    """Tiny encoder for tests."""
    return SonarTextEncoderConfig(
        model_dim=32,
        max_seq_len=512,
        vocab_info=_TOY_VOCAB,
        num_encoder_layers=2,
        num_decoder_layers=2,
        num_encoder_attn_heads=4,
        num_decoder_attn_heads=4,
        ffn_inner_dim=128,
        pooling="mean",
        _from_fairseq=True,
    )


@sonar_text_decoder_archs.arch("basic")
def _decoder_basic() -> SonarTextDecoderConfig:
    return SonarTextDecoderConfig(
        model_dim=1024,
        max_seq_len=512,
        vocab_info=NLLB_VOCAB,
        normalize_before=True,
        num_encoder_layers=24,
        num_decoder_layers=24,
        num_encoder_attn_heads=16,
        num_decoder_attn_heads=16,
        ffn_inner_dim=1024 * 8,
    )


@sonar_text_decoder_archs.arch("small")
def _decoder_small() -> SonarTextDecoderConfig:
    cfg = _decoder_basic()
    return dataclasses.replace(
        cfg,
        vocab_info=_SMALL_VOCAB,
        num_encoder_layers=6,
        num_decoder_layers=6,
        ffn_inner_dim=1024 * 4,
    )


@sonar_text_decoder_archs.arch("toy")
def _decoder_toy() -> SonarTextDecoderConfig:
    """Tiny decoder for tests."""
    return SonarTextDecoderConfig(
        model_dim=32,
        max_seq_len=512,
        vocab_info=_TOY_VOCAB,
        normalize_before=True,
        num_encoder_layers=2,
        num_decoder_layers=2,
        num_encoder_attn_heads=4,
        num_decoder_attn_heads=4,
        ffn_inner_dim=128,
    )
