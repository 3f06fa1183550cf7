"""The system under test for an NLLB-MoE configuration: the port's
``TextToTextModelPipeline`` over the ``TorchEncoderDecoder`` of an
``NllbMoeModel`` that holds the benchmark's weights (``runtime``: the
compute dtype) and the configuration's experts (``num_experts`` held here,
from ``experts_first``, of the router's ``router_experts``)."""

from __future__ import annotations

from typing import Any, Tuple


def model_config(cfg: dict) -> Any:
    from sonar_tpu_torch.models.common import VocabularyInfo
    from sonar_tpu_torch.models.nllb_moe.config import NllbMoeConfig

    m = cfg["model"]
    first = m["experts_first"]
    return NllbMoeConfig(
        model_dim=m["model_dim"], num_encoder_layers=m["num_encoder_layers"],
        num_decoder_layers=m["num_decoder_layers"],
        num_encoder_attn_heads=m["num_encoder_attn_heads"],
        num_decoder_attn_heads=m["num_decoder_attn_heads"], ffn_inner_dim=m["ffn_inner_dim"],
        num_experts=m["router_experts"], encoder_sparse_step=m["encoder_sparse_step"],
        decoder_sparse_step=m["decoder_sparse_step"], max_seq_len=m["max_seq_len"],
        vocab_info=VocabularyInfo(**m["vocab_info"]),
        experts_held=(first, first + m["num_experts"]))


def build(torch: Any, cfg: dict, tree: dict, tokenizer: Any, device: Any) -> Tuple[Any, Any]:
    """-> (pipeline, its TorchEncoderDecoder)."""
    from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline
    from sonar_tpu_torch.models.nllb_moe.model import NllbMoeModel

    model = NllbMoeModel(model_config(cfg), tree, dtype=getattr(torch, cfg["runtime"]["dtype"]))
    pipe = TextToTextModelPipeline(model, model, tokenizer, device=device)
    return pipe, pipe.decoder
