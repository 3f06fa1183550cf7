"""HF audio pipeline: dataset audio columns -> SONAR embeddings.

The port's copy of ``sonar_tpu.huggingface.audio``: casts the audio column
to 16 kHz, averages multichannel to mono, normalizes shapes to [T], and runs
the port's batched ``SpeechToEmbeddingModelPipeline.predict`` on
``config.device`` (the GPU unless ``"cpu"``). A row whose audio cannot be
normalised is skipped (its output is None), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
import logging
from typing import Any, Dict, List, Optional

import numpy as np

from sonar_tpu_torch.huggingface.pipeline import DatasetConfig, Pipeline, PipelineConfig

logger = logging.getLogger(__name__)


@dataclass
class AudioDatasetConfig(DatasetConfig):
    audio_column: str = "audio"
    sampling_rate: int = 16000

    def load_dataset(self) -> Any:
        import datasets

        ds = super().load_dataset()
        ds = ds.cast_column(
            self.audio_column, datasets.Audio(sampling_rate=self.sampling_rate)
        )
        return ds


def normalize_audio(entry: Any) -> Optional[np.ndarray]:
    """dataset audio entry -> mono [T] float32 (channel-mean for multich)."""
    if entry is None:
        return None
    array = entry.get("array") if isinstance(entry, dict) else entry
    if array is None:
        return None
    x = np.asarray(array, np.float32)
    if x.ndim == 2:
        x = x.mean(axis=0 if x.shape[0] < x.shape[1] else 1)
    return x.reshape(-1)


@dataclass
class HFAudioToEmbeddingPipelineConfig(PipelineConfig):
    encoder_model: Any = None
    audio_column: str = "audio"
    sub_batch_size: int = 4
    n_parallel: int = 2


class HFAudioToEmbeddingPipeline(Pipeline):
    config: HFAudioToEmbeddingPipelineConfig

    def __init__(self, config: HFAudioToEmbeddingPipelineConfig):
        super().__init__(config)
        from sonar_tpu_torch.inference_pipelines.speech import (
            SpeechToEmbeddingModelPipeline,
        )

        self._pipeline = SpeechToEmbeddingModelPipeline(
            encoder=config.encoder_model, device=config.device
        )

    def process_batch(self, batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        cfg = self.config
        out = dict(batch)
        waves, keep = [], []
        for i, entry in enumerate(batch[cfg.audio_column]):
            try:
                w = normalize_audio(entry)
            except Exception:
                logger.exception("failed to normalize audio row %d", i)
                w = None
            if w is not None and w.size:
                waves.append(w)
                keep.append(i)
        n = len(batch[cfg.audio_column])
        result: List[Optional[List[float]]] = [None] * n
        if waves:
            emb = self._pipeline.predict(
                waves, batch_size=cfg.sub_batch_size, n_parallel=cfg.n_parallel
            )
            for row, i in zip(emb, keep):
                result[i] = row.tolist()
        out[f"{cfg.audio_column}_{cfg.output_column_suffix}"] = result
        return out
