"""The system under test for a speech-encoder configuration: the port's
``SpeechToEmbeddingModelPipeline`` over a ``TorchSpeechEncoder`` that holds
the benchmark's weights (``runtime`` of the configuration file: the compute
dtype, int8 weights or not, the fbank's dtype)."""

from __future__ import annotations

from typing import Any, Tuple


def model_config(cfg: dict) -> Any:
    from sonar_tpu_torch.models.sonar_speech.config import (
        SonarSpeechEncoderConfig,
        W2VBertFrontendConfig,
    )
    from sonar_tpu_torch.nn.conformer import ConformerConfig

    m = cfg["model"]
    d = m["model_dim"]
    return SonarSpeechEncoderConfig(
        conformer=ConformerConfig(model_dim=d, num_layers=m["num_encoder_layers"],
                                  num_heads=m["num_encoder_attn_heads"],
                                  ffn_inner_dim=m["ffn_inner_dim"],
                                  depthwise_kernel_size=m["depthwise_kernel_size"]),
        frontend=W2VBertFrontendConfig(num_fbank_channels=m["num_fbank_channels"],
                                       fbank_stride=m["fbank_stride"], model_dim=d),
        model_dim=d, max_seq_len=m["max_seq_len"], bos_idx=m["bos_idx"],
        num_decoder_layers=m["num_decoder_layers"],
        num_decoder_attn_heads=m["num_decoder_attn_heads"],
        ffn_inner_dim=m["pooler_ffn_inner_dim"],
    )


def build(torch: Any, cfg: dict, tree: dict, device: Any) -> Tuple[Any, Any]:
    """-> (pipeline, its TorchSpeechEncoder)."""
    from sonar_tpu_torch.inference_pipelines.speech import (
        SpeechToEmbeddingModelPipeline,
        TorchSpeechEncoder,
    )
    from sonar_tpu_torch.models.sonar_speech.model import SonarSpeechEncoder

    rt = cfg["runtime"]
    model = SonarSpeechEncoder(model_config(cfg), tree, dtype=getattr(torch, rt["dtype"]))
    encoder = TorchSpeechEncoder(model, quantize=rt["quantize"],
                                 fbank_dtype=rt["fbank_dtype"], device=device)
    return SpeechToEmbeddingModelPipeline(encoder), encoder
