"""Card name -> loaded encoder, decoder, head or tokenizer (``sonar_tpu.assets.hub``).

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


def _head_state(name: str, family: str) -> tuple:
    """(card, flat state dict) of a head's card."""
    from sonar_tpu_torch.assets.checkpoint import load_torch_state_dict

    card = _card(name, family, f"{family} model")
    return card, load_torch_state_dict(cached_path(card.checkpoint))


def load_blaser_model(name: str, device: Any = None) -> Any:
    """-> ``BlaserModel`` on ``device`` (fp32)."""
    from sonar_tpu_torch.assets.convert import blaser_from_numpy
    from sonar_tpu_torch.models.blaser.model import blaser_archs, blaser_params_from_torch

    device = resolve_device(device)
    card, flat = _head_state(name, "blaser")
    return blaser_from_numpy(blaser_params_from_torch(flat), blaser_archs.get(card.arch), device)


def load_mutox_model(name: str, device: Any = None) -> Any:
    """-> ``MutoxClassifier`` on ``device`` (fp32)."""
    from sonar_tpu_torch.assets.convert import mutox_from_numpy
    from sonar_tpu_torch.models.mutox.model import mutox_archs, mutox_params_from_torch

    device = resolve_device(device)
    card, flat = _head_state(name, "mutox")
    return mutox_from_numpy(mutox_params_from_torch(flat), mutox_archs.get(card.arch), device)


def load_laser2_model(name: str, dtype: torch.dtype = torch.float32, device: Any = None) -> Any:
    """-> ``LaserLstmEncoder`` on ``device``."""
    from sonar_tpu_torch.assets.convert import laser2_from_numpy
    from sonar_tpu_torch.models.laser2_text.model import laser2_archs, laser2_params_from_torch

    device = resolve_device(device)
    card, flat = _head_state(name, "laser2")
    return laser2_from_numpy(laser2_params_from_torch(flat), laser2_archs.get(card.arch), dtype,
                             device)


def load_tokenizer(name: str) -> Any:
    store = default_store()
    card = store.tokenizer_card(name)
    if card.family == "nllb":
        from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer

        return NllbTokenizer(cached_path(card.model), langs=store.text_languages,
                             default_lang=card.default_lang)
    if card.family in ("laser2", "lstm"):
        from sonar_tpu_torch.tokenizers.laser2 import Laser2Tokenizer

        return Laser2Tokenizer(cached_path(card.model))
    raise ValueError(f"unsupported tokenizer family: {card.family}")


class _Hub:
    """Reference-style accessor: ``get_*_hub().load(name, device=..., dtype=...)``."""

    def __init__(self, loader: Any):
        self._loader = loader

    def load(self, name: str, device: Any = None, dtype: Any = None, **kwargs: Any) -> Any:
        if dtype is not None:
            kwargs["dtype"] = dtype
        return self._loader(name, device=device, **kwargs)


def get_sonar_text_encoder_hub() -> _Hub:
    return _Hub(load_text_encoder)


def get_sonar_text_decoder_hub() -> _Hub:
    return _Hub(load_text_decoder)


def get_sonar_speech_encoder_hub() -> _Hub:
    return _Hub(load_speech_encoder)


def get_blaser_model_hub() -> _Hub:
    return _Hub(lambda name, device=None, **kw: load_blaser_model(name, device))


def get_mutox_model_hub() -> _Hub:
    return _Hub(lambda name, device=None, **kw: load_mutox_model(name, device))


def get_laser2_model_hub() -> _Hub:
    return _Hub(load_laser2_model)


def get_text_tokenizer_hub() -> _Hub:
    return _Hub(lambda name, **kw: load_tokenizer(name))
