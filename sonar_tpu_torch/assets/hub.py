"""Card name -> loaded text encoder (``sonar_tpu.assets.hub.load_text_encoder``).

The asset-card registry (``sonar_tpu.assets.store``) needs PyYAML, so it is
imported only when a card is loaded.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder


def load_text_encoder(name: str, dtype: torch.dtype = torch.float32, device: Any = None,
                      fuse_qkv: bool = True, quantize: bool = False) -> "TorchTextEncoder":
    from sonar_tpu.assets.store import cached_path, default_store
    from sonar_tpu_torch.assets.convert import load_text_encoder_checkpoint
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    card = default_store().model_card(name)
    if card.family != "sonar_text_encoder":
        raise ValueError(f"'{name}' is a {card.family} card, not a text encoder")
    config = sonar_text_encoder_archs.get(card.arch)
    model = load_text_encoder_checkpoint(cached_path(card.checkpoint), config, dtype)
    return TorchTextEncoder(model, fuse_qkv=fuse_qkv, quantize=quantize, device=device)


def load_tokenizer(name: str) -> Any:
    from sonar_tpu.assets.store import cached_path, default_store
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer

    store = default_store()
    card = store.tokenizer_card(name)
    if card.family != "nllb":
        raise ValueError(f"unsupported tokenizer family: {card.family}")
    return NllbTokenizer(cached_path(card.model), langs=store.text_languages,
                         default_lang=card.default_lang)
