"""Encoder-decoder composition through the 1024-d bottleneck
(``sonar_tpu.models.sonar_translation.model``).

``encode_to_memory`` runs any SONAR encoder and hands the decoder a
length-1 memory holding the pooled sentence embedding (an encoder-decoder
model's encoder, ``TorchEncoderDecoder``, hands it the source's sequence
memory and lengths, ``SequenceMemory``, as they are); ``generate``
delegates to the decoder runtime (``TorchTextDecoder``): beam search, or
sampling when it is given a sampler.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch


class DummyEncoderModel:
    """Pass-through encoder: the inputs are already sentence embeddings."""

    def encode(self, embeddings: Any) -> np.ndarray:
        return np.asarray(embeddings, np.float32)


class SonarEncoderDecoderModel:
    """Pairs an encoder (``encode_batch(SequenceBatch)`` for text,
    ``encode_waveforms(list)`` for speech, or ``DummyEncoderModel``) with a
    ``TorchTextDecoder``."""

    def __init__(self, encoder: Any, decoder: Any):
        self.encoder = encoder
        self.decoder = decoder

    def encode_to_memory(self, encoder_inputs: Any) -> Any:
        """-> [B, 1, D] length-1 decoder memory, or a sequence memory with
        its lengths from an encoder that gives one."""
        if isinstance(self.encoder, DummyEncoderModel):
            emb = self.encoder.encode(encoder_inputs)
        elif hasattr(self.encoder, "encode_waveforms"):
            emb = self.encoder.encode_waveforms(encoder_inputs)
        else:
            emb = self.encoder.encode_batch(encoder_inputs)
        if hasattr(emb, "lens"):  # a sequence memory, as the decoder takes it
            return emb
        if torch.is_tensor(emb):
            emb = emb.float().cpu().numpy()
        return np.asarray(emb, np.float32)[:, None, :]

    def generate(self, encoder_inputs: Any, prefix_ids: Sequence[int], gen_config: Any,
                 sampler: Any = None) -> Any:
        memory = self.encode_to_memory(encoder_inputs)
        if sampler is not None:
            return self.decoder.generate_sample(memory, prefix_ids, sampler,
                                                max_gen_len=gen_config.max_gen_len,
                                                min_gen_len=gen_config.min_gen_len)
        return self.decoder.generate_beam(memory, prefix_ids, gen_config)


def create_sonar_text_encoder_decoder_model(encoder: Any, decoder: Any) -> SonarEncoderDecoderModel:
    return SonarEncoderDecoderModel(encoder, decoder)


def create_sonar_speech_to_text_model(speech_encoder: Any,
                                      text_decoder: Any) -> SonarEncoderDecoderModel:
    return SonarEncoderDecoderModel(speech_encoder, text_decoder)
