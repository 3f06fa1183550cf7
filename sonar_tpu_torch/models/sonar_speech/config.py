"""SONAR speech encoder configs (``sonar_tpu.models.sonar_speech.config``).

Both published archs wrap the w2v-BERT ``600m`` Conformer (24 x 1024, FFN
4096, 16 heads, fbank 80 x 2 -> 160-d features) and differ only in pooler
depth (english: 3 post-LN decoder layers, non_english: 6).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from sonar_tpu_torch.models.common import ConfigRegistry
from sonar_tpu_torch.nn.conformer import ConformerConfig


@dataclass(frozen=True)
class W2VBertFrontendConfig:
    """Fbank feature frontend of w2v-BERT: stacked frames, LayerNorm,
    projection to the model width."""

    num_fbank_channels: int = 80
    fbank_stride: int = 2
    model_dim: int = 1024

    @property
    def feature_dim(self) -> int:
        return self.num_fbank_channels * self.fbank_stride


@dataclass(frozen=True)
class SonarSpeechEncoderConfig:
    conformer: ConformerConfig = field(default_factory=ConformerConfig)
    frontend: W2VBertFrontendConfig = field(default_factory=W2VBertFrontendConfig)
    final_dropout_p: float = 0.1
    model_dim: int = 1024
    max_seq_len: int = 1024
    pad_idx: int = 1
    bos_idx: int = 2
    num_decoder_layers: int = 3
    num_decoder_attn_heads: int = 16
    decoder_norm_order: str = "post"
    ffn_inner_dim: int = 4096
    dropout_p: float = 0.1


sonar_speech_encoder_archs: ConfigRegistry[SonarSpeechEncoderConfig] = ConfigRegistry(
    "sonar_speech_encoder"
)


@sonar_speech_encoder_archs.arch("english")
def _english() -> SonarSpeechEncoderConfig:
    return SonarSpeechEncoderConfig(num_decoder_layers=3)


@sonar_speech_encoder_archs.arch("non_english")
def _non_english() -> SonarSpeechEncoderConfig:
    return SonarSpeechEncoderConfig(num_decoder_layers=6)


@sonar_speech_encoder_archs.arch("toy")
def _toy() -> SonarSpeechEncoderConfig:
    """Tiny structural-test arch (not in the reference registry)."""
    return SonarSpeechEncoderConfig(
        conformer=ConformerConfig(model_dim=32, num_layers=2, num_heads=4, ffn_inner_dim=64,
                                  depthwise_kernel_size=7),
        frontend=W2VBertFrontendConfig(num_fbank_channels=8, fbank_stride=2, model_dim=32),
        model_dim=32,
        num_decoder_layers=2,
        num_decoder_attn_heads=4,
        ffn_inner_dim=64,
    )
