"""HF text pipelines: sentence segmentation, text<->embedding columns.

The port's copy of ``sonar_tpu.huggingface.text``:

- ``TextSegmentationPipeline``: sentence splitting with missing-value
  policies (skip/remove/fill); a self-contained rule-based splitter, or
  spaCy when it is installed and has a model for the language,
- ``HFTextToEmbeddingPipeline``: encodes string columns AND list-of-list
  columns (flatten + prefix-sum re-nesting) with the port's
  ``TextToEmbeddingModelPipeline``,
- ``HFEmbeddingToTextPipeline``: decodes embedding columns back to text
  with the port's ``EmbeddingToTextModelPipeline``.

Both model pipelines run on ``config.device`` (the GPU unless ``"cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import accumulate
import re
from typing import Any, Dict, List, Optional

import numpy as np

from sonar_tpu_torch.huggingface.pipeline import Pipeline, PipelineConfig

_SENT_BOUNDARY = re.compile(
    r"(?<=[.!?。！？])[\s]+(?=[^\s])"
)
_ABBREV = {"mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "etc", "e.g", "i.e",
           "vs", "fig", "no"}


def split_sentences(text: str) -> List[str]:
    """Lightweight rule-based sentence splitter (spaCy-free default)."""
    if not text:
        return []
    parts = _SENT_BOUNDARY.split(text.strip())
    out: List[str] = []
    for part in parts:
        if out:
            prev = out[-1].rstrip()
            last_word = prev.rsplit(" ", 1)[-1].rstrip(".").lower()
            if last_word in _ABBREV or (len(last_word) == 1 and last_word.isalpha()):
                out[-1] = out[-1] + " " + part
                continue
        out.append(part)
    return [s.strip() for s in out if s.strip()]


@dataclass
class TextSegmentationPipelineConfig(PipelineConfig):
    fill_value: str = ""
    handle_missing: str = "skip"  # skip | remove | fill
    source_lang: str = "eng_Latn"


class TextSegmentationPipeline(Pipeline):
    config: TextSegmentationPipelineConfig

    # Language -> spaCy model, the JAX package's 7 languages. Languages
    # outside the map use the rule-based splitter rather than mis-segmenting
    # with an English model.
    SPACY_MODELS = {
        "eng_Latn": "en_core_web_sm",
        "fra_Latn": "fr_core_news_sm",
        "deu_Latn": "de_core_news_sm",
        "spa_Latn": "es_core_news_sm",
        "ita_Latn": "it_core_news_sm",
        "por_Latn": "pt_core_news_sm",
        "nld_Latn": "nl_core_news_sm",
    }

    def __init__(self, config: TextSegmentationPipelineConfig):
        super().__init__(config)
        self._spacy = self._try_spacy(config.source_lang)

    @classmethod
    def _try_spacy(cls, lang: str):
        model = cls.SPACY_MODELS.get(lang)
        if model is None:
            return None
        try:  # pragma: no cover - spaCy not installed in this environment
            import spacy

            return spacy.load(model)
        except Exception:
            return None

    def segment(self, text: str) -> List[str]:
        if self._spacy is not None:  # pragma: no cover
            return [s.text.strip() for s in self._spacy(text).sents if s.text.strip()]
        return split_sentences(text)

    def process_batch(self, batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        cfg = self.config
        out = dict(batch)
        for col in cfg.columns:
            values = batch[col]
            handled = []
            for v in values:
                if v is None or (isinstance(v, str) and not v.strip()):
                    if cfg.handle_missing == "fill":
                        v = cfg.fill_value
                    elif cfg.handle_missing == "remove":
                        handled.append(None)
                        continue
                    elif cfg.handle_missing == "skip":
                        handled.append([])
                        continue
                    else:
                        raise ValueError(
                            f"unknown handle_missing: {cfg.handle_missing}"
                        )
                handled.append(self.segment(v))
            out[f"{col}_{cfg.output_column_suffix}"] = handled
        if cfg.handle_missing == "remove":
            keep = [i for i, v in enumerate(
                out[f"{cfg.columns[0]}_{cfg.output_column_suffix}"]) if v is not None]
            out = {k: [vals[i] for i in keep] for k, vals in out.items()}
        return out


@dataclass
class HFTextToEmbeddingPipelineConfig(PipelineConfig):
    encoder_model: Any = None      # card name, TorchTextEncoder or SonarTextEncoder
    tokenizer: Any = None
    source_lang: str = "eng_Latn"
    sub_batch_size: Optional[int] = 32
    dtype: str = "float32"


class HFTextToEmbeddingPipeline(Pipeline):
    config: HFTextToEmbeddingPipelineConfig

    def __init__(self, config: HFTextToEmbeddingPipelineConfig):
        super().__init__(config)
        from sonar_tpu_torch.inference_pipelines.text import TextToEmbeddingModelPipeline

        self._pipeline = TextToEmbeddingModelPipeline(
            encoder=config.encoder_model, tokenizer=config.tokenizer,
            device=config.device,
        )

    def _encode(self, texts: List[str]) -> np.ndarray:
        return self._pipeline.predict(
            texts,
            source_lang=self.config.source_lang,
            batch_size=self.config.sub_batch_size,
        ).astype(self.config.dtype)

    def process_batch(self, batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        cfg = self.config
        out = dict(batch)
        for col in cfg.columns:
            values = batch[col]
            if values and isinstance(values[0], list):
                # list-of-sentences column: flatten, encode, re-nest by
                # prefix sums.
                lengths = [len(v) for v in values]
                flat = [s for v in values for s in v]
                if flat:
                    emb = self._encode(flat)
                else:
                    emb = np.zeros((0, 1), np.float32)
                bounds = [0] + list(accumulate(lengths))
                nested = [
                    emb[bounds[i] : bounds[i + 1]].tolist() for i in range(len(values))
                ]
                out[f"{col}_{cfg.output_column_suffix}"] = nested
            else:
                out[f"{col}_{cfg.output_column_suffix}"] = self._encode(
                    list(values)
                ).tolist()
        return out


@dataclass
class HFEmbeddingToTextPipelineConfig(PipelineConfig):
    decoder_model: Any = None
    tokenizer: Any = None
    target_lang: str = "eng_Latn"
    sub_batch_size: int = 32
    max_seq_len: Optional[int] = None


class HFEmbeddingToTextPipeline(Pipeline):
    config: HFEmbeddingToTextPipelineConfig

    def __init__(self, config: HFEmbeddingToTextPipelineConfig):
        super().__init__(config)
        from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline

        self._pipeline = EmbeddingToTextModelPipeline(
            decoder=config.decoder_model, tokenizer=config.tokenizer,
            device=config.device,
        )

    def _decode(self, embeddings: np.ndarray) -> List[str]:
        kwargs = {}
        if self.config.max_seq_len is not None:
            kwargs["max_seq_len"] = self.config.max_seq_len
        return self._pipeline.predict(
            embeddings,
            target_lang=self.config.target_lang,
            batch_size=self.config.sub_batch_size,
            **kwargs,
        )

    def process_batch(self, batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        cfg = self.config
        out = dict(batch)
        for col in cfg.columns:
            values = batch[col]
            first = values[0] if len(values) else None
            # Nested = each row holds a LIST of embeddings (sentence-level
            # column from a segmented pipeline) rather than one embedding.
            # Works for python lists and for numpy-formatted datasets: a
            # row that is a 2-D array, or a list whose first element is
            # itself a vector (list or 1-D ndarray), is nested.
            if isinstance(first, np.ndarray):
                nested = first.ndim >= 2
            elif isinstance(first, list) and first:
                nested = np.ndim(first[0]) >= 1
            else:
                nested = False
            if nested:
                lengths = [len(v) for v in values]
                flat = np.asarray(
                    [np.asarray(e, np.float32) for v in values for e in v]
                )
                texts = self._decode(flat) if len(flat) else []
                bounds = [0] + list(accumulate(lengths))
                out[f"{col}_{cfg.output_column_suffix}"] = [
                    texts[bounds[i] : bounds[i + 1]] for i in range(len(values))
                ]
            else:
                out[f"{col}_{cfg.output_column_suffix}"] = self._decode(
                    np.asarray(values, np.float32)
                )
        return out
