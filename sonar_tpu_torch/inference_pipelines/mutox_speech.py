"""MuTox speech toxicity pipeline (``sonar_tpu.inference_pipelines.mutox_speech``):
audio -> the port's speech encoder -> the MuTox classifier.

The embeddings of each batch stay on the device into the classifier, which
must sit on the encoder's device (a classifier elsewhere raises rather than
copy the embeddings across); the scores come back as numpy.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np
from sonar_tpu_torch.data.pipeline import DataPipelineBuilder, read_sequence
from sonar_tpu_torch.inference_pipelines.speech import (
    AudioToFbankDataPipelineBuilder,
    SpeechInferenceParams,
    SpeechModelPipelineInterface,
    _resolve_speech_encoder,
)
import torch


def _placed(device: torch.device) -> torch.device:
    """``device`` with a bare ``cuda`` read as the current card."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class MutoxSpeechClassifierPipeline(SpeechModelPipelineInterface):
    """``mutox_classifier``: a ``MutoxClassifier`` or a card name;
    ``encoder``: a speech encoder, its ``TorchSpeechEncoder`` or a card name."""

    def __init__(self, mutox_classifier: Any, encoder: Any, device: Any = None) -> None:
        super().__init__()
        self.model = _resolve_speech_encoder(encoder, device=device)
        if isinstance(mutox_classifier, str):
            from sonar_tpu_torch.assets.hub import load_mutox_model

            mutox_classifier = load_mutox_model(mutox_classifier, device=self.model.device)
        if _placed(mutox_classifier.device) != _placed(self.model.device):
            raise ValueError(
                f"the MuTox classifier is on {mutox_classifier.device} and the speech encoder "
                f"on {self.model.device}: build both on one device"
            )
        self.mutox_classifier = mutox_classifier
        self._audio_builder = AudioToFbankDataPipelineBuilder()

    @classmethod
    def load_model_from_name(cls, mutox_classifier_name: str, encoder_name: str,
                             device: Any = None) -> "MutoxSpeechClassifierPipeline":
        return cls(mutox_classifier_name, encoder_name, device)

    def _classify(self, waves: List[np.ndarray], output_prob: bool = False) -> np.ndarray:
        embeddings = self.model.encode_waveforms(waves, materialize=False)
        return self.mutox_classifier(embeddings, output_prob).cpu().numpy()

    def prebuild_pipeline(self, context: SpeechInferenceParams) -> DataPipelineBuilder:
        return self._audio_builder.prebuild_pipeline(context).map(self._classify)

    def build_pipeline(self, context: SpeechInferenceParams) -> Any:
        return self.prebuild_pipeline(context).and_return()

    def predict(self, input: Sequence, batch_size: int = 4, n_parallel: int = 1,
                output_prob: bool = False) -> np.ndarray:
        """Clips (arrays or wav paths) in arrival order -> [N, 1] scores."""
        pipeline = (
            read_sequence(list(input))
            .map(self._decode_audio, num_parallel_calls=n_parallel)
            .bucket(batch_size)
            .map(lambda waves: self._classify(waves, output_prob))
            .and_return()
        )
        return np.concatenate(list(iter(pipeline)), axis=0)
