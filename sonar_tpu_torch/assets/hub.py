"""Card name -> loaded encoder, decoder or tokenizer (``sonar_tpu.assets.hub``).

Cards come from the port's copy of the asset registry
(``sonar_tpu_torch.assets.store``), which imports PyYAML only when a card
is read. Every loader runs on the GPU unless it is given ``device="cpu"``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

from sonar_tpu_torch.assets.store import cached_path, default_store
from sonar_tpu_torch.device import resolve_device
import torch

if TYPE_CHECKING:
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder


def _card(name: str, family: str, what: str) -> Any:
    card = default_store().model_card(name)
    if card.family != family:
        raise ValueError(f"'{name}' is a {card.family} card, not a {what}")
    return card


def load_text_encoder(name: str, dtype: torch.dtype = torch.float32, device: Any = None,
                      fuse_qkv: bool = True, quantize: bool = False) -> "TorchTextEncoder":
    from sonar_tpu_torch.assets.convert import load_text_encoder_checkpoint
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    device = resolve_device(device)
    card = _card(name, "sonar_text_encoder", "text encoder")
    config = sonar_text_encoder_archs.get(card.arch)
    model = load_text_encoder_checkpoint(cached_path(card.checkpoint), config, dtype, device)
    return TorchTextEncoder(model, fuse_qkv=fuse_qkv, quantize=quantize, device=device)


def load_speech_encoder(name: str, dtype: torch.dtype = torch.float32, device: Any = None,
                        quantize: bool = False) -> "TorchSpeechEncoder":
    from sonar_tpu_torch.assets.convert import load_speech_encoder_checkpoint
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs

    device = resolve_device(device)
    card = _card(name, "sonar_speech_encoder", "speech encoder")
    config = sonar_speech_encoder_archs.get(card.arch)
    model = load_speech_encoder_checkpoint(cached_path(card.checkpoint), config, dtype, device)
    return TorchSpeechEncoder(model, quantize=quantize, device=device)


def load_text_decoder(name: str, dtype: torch.dtype = torch.float32, device: Any = None,
                      quantize: bool = False) -> "TorchTextDecoder":
    from sonar_tpu_torch.assets.convert import load_text_decoder_checkpoint
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    device = resolve_device(device)
    card = _card(name, "sonar_text_decoder", "text decoder")
    config = sonar_text_decoder_archs.get(card.arch)
    model = load_text_decoder_checkpoint(cached_path(card.checkpoint), config, dtype, device)
    return TorchTextDecoder(model, quantize=quantize, device=device)


def load_tokenizer(name: str) -> Any:
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer

    store = default_store()
    card = store.tokenizer_card(name)
    if card.family != "nllb":
        raise ValueError(f"unsupported tokenizer family: {card.family}")
    return NllbTokenizer(cached_path(card.model), langs=store.text_languages,
                         default_lang=card.default_lang)
