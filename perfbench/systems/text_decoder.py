"""The system under test for a text-decoder configuration: the port's
``EmbeddingToTextModelPipeline`` over a ``TorchTextDecoder`` that holds the
benchmark's weights (``runtime``: the compute dtype, int8 weights)."""

from __future__ import annotations

from typing import Any, Tuple


def model_config(cfg: dict) -> Any:
    from sonar_tpu_torch.models.common import VocabularyInfo
    from sonar_tpu_torch.models.sonar_text.config import SonarTextDecoderConfig

    fields = {k: v for k, v in cfg["model"].items() if k != "vocab_info"}
    return SonarTextDecoderConfig(vocab_info=VocabularyInfo(**cfg["model"]["vocab_info"]),
                                  **fields)


def build(torch: Any, cfg: dict, tree: dict, tokenizer: Any, device: Any) -> Tuple[Any, Any]:
    """-> (pipeline, its TorchTextDecoder)."""
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder

    rt = cfg["runtime"]
    model = ConditionalTransformerDecoder(model_config(cfg), tree,
                                          dtype=getattr(torch, rt["dtype"]))
    decoder = TorchTextDecoder(model, quantize=rt["quantize"], device=device)
    return EmbeddingToTextModelPipeline(decoder, tokenizer), decoder
