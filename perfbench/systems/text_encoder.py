"""The system under test for a text-encoder configuration: the port's
``TextToEmbeddingModelPipeline`` over a ``TorchTextEncoder`` that holds the
benchmark's weights (``runtime`` of the configuration file: the compute
dtype, the fused QKV projection, int8 weights)."""

from __future__ import annotations

from typing import Any, Tuple


def model_config(cfg: dict) -> Any:
    from sonar_tpu_torch.models.common import VocabularyInfo
    from sonar_tpu_torch.models.sonar_text.config import SonarTextEncoderConfig

    fields = {k: v for k, v in cfg["model"].items() if k != "vocab_info"}
    return SonarTextEncoderConfig(vocab_info=VocabularyInfo(**cfg["model"]["vocab_info"]),
                                  **fields)


def build(torch: Any, cfg: dict, tree: dict, tokenizer: Any, device: Any) -> Tuple[Any, Any]:
    """-> (pipeline, its TorchTextEncoder)."""
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TorchTextEncoder,
    )
    from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder

    rt = cfg["runtime"]
    model = SonarTextEncoder(model_config(cfg), tree, dtype=getattr(torch, rt["dtype"]))
    encoder = TorchTextEncoder(model, fuse_qkv=rt["fuse_qkv"], quantize=rt["quantize"],
                               device=device)
    return TextToEmbeddingModelPipeline(encoder, tokenizer), encoder
