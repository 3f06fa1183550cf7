"""HuggingFace ``datasets`` batch-processing layer.

The port's copy of ``sonar_tpu.huggingface.pipeline``: a config-driven
``dataset.map`` runner with caching/streaming, a ``load_dataset`` wrapper
with communication-free shard-by-(world, rank) parallelism, and (in the
sibling modules) pipelines for text segmentation, text->embedding,
embedding->text and audio->embedding over the port's model pipelines.
``PipelineConfig.device`` (default ``"cuda"``) is the device every model
pipeline of the layer runs on.

All imports of ``datasets`` are function-local so the package has no hard
dependency on it.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
import gc
import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    columns: List[str] = field(default_factory=list)
    output_column_suffix: str = "output"
    batch_size: int = 32
    device: str = "cuda"
    take: Optional[int] = None
    output_path: Optional[str] = None
    # Arrow cache for resumable batch processing: non-streaming datasets
    # are mapped in chunks of ``cache_chunk_batches`` batches, each persisted
    # to ``output_path/cache_<Pipeline>_<chunk>.arrow``; a re-run after a
    # crash skips every completed chunk.
    cache_to_arrow: bool = False
    load_from_cache_file: bool = True
    cache_chunk_batches: int = 64


@dataclass
class DatasetConfig:
    """``load_dataset`` wrapper + shard-by-rank data parallelism.

    ``world_size``/``rank`` shard the dataset between processes; under
    ``torch.distributed``, pass ``get_world_size()`` / ``get_rank()``.
    """

    dataset_name: str
    dataset_split: str = "train"
    config: Optional[str] = None
    trust_remote_code: bool = False
    world_size: int = 1
    rank: int = 0
    streaming: bool = False

    def load_dataset(self) -> Any:
        import datasets

        ds = datasets.load_dataset(
            self.dataset_name,
            self.config,
            split=self.dataset_split,
            streaming=self.streaming,
            trust_remote_code=self.trust_remote_code,
        )
        if self.world_size > 1:
            ds = ds.shard(num_shards=self.world_size, index=self.rank)
        return ds


class Pipeline(ABC):
    """Batched ``dataset.map`` runner."""

    def __init__(self, config: PipelineConfig):
        self.config = config

    @abstractmethod
    def process_batch(self, batch: Dict[str, List[Any]]) -> Dict[str, List[Any]]:
        ...

    def resource_manager(self) -> None:
        """Host-memory housekeeping after a map, as in the JAX package (the
        CUDA caching allocator keeps its blocks for the next batch)."""
        gc.collect()

    def __call__(self, dataset):
        if self.config.take is not None:
            dataset = dataset.take(self.config.take)

        def mapper(batch):
            try:
                out = self.process_batch(batch)
            except Exception:
                logger.exception("pipeline batch failed")
                raise
            return out

        kwargs: Dict[str, Any] = dict(batched=True, batch_size=self.config.batch_size)
        # Streaming datasets (IterableDataset) have no random access / Arrow
        # backing, so the cache path only applies to regular datasets.
        cached = (
            self.config.cache_to_arrow
            and self.config.output_path
            and hasattr(dataset, "select")
        )
        if cached:
            result = self._map_with_arrow_cache(dataset, mapper, kwargs)
        else:
            result = dataset.map(mapper, **kwargs)
        self.resource_manager()
        if self.config.output_path and hasattr(result, "save_to_disk"):
            # The cache .arrow files back `result`, so the final dataset must
            # go to a subdirectory (save_to_disk refuses to overwrite them).
            target = (
                os.path.join(self.config.output_path, "dataset")
                if cached
                else self.config.output_path
            )
            result.save_to_disk(target)
        return result

    def _map_with_arrow_cache(self, dataset, mapper, map_kwargs: Dict[str, Any]):
        """Chunked ``dataset.map`` with per-chunk Arrow cache files.

        Each chunk of ``cache_chunk_batches`` batches maps to its own
        ``cache_<Pipeline>_<chunk>.arrow`` under ``output_path``; HF datasets
        loads an existing cache file instead of recomputing, so re-running
        after a mid-run crash resumes from the first incomplete chunk.
        """
        import datasets as hf_datasets

        os.makedirs(self.config.output_path, exist_ok=True)
        rows_per_chunk = self.config.batch_size * self.config.cache_chunk_batches
        n = len(dataset)
        parts = []
        for ci, start in enumerate(range(0, max(n, 1), rows_per_chunk)):
            chunk = dataset.select(range(start, min(start + rows_per_chunk, n)))
            cache_file = os.path.join(
                self.config.output_path,
                f"cache_{type(self).__name__}_{ci:05d}.arrow",
            )
            parts.append(
                chunk.map(
                    mapper,
                    cache_file_name=cache_file,
                    load_from_cache_file=self.config.load_from_cache_file,
                    **map_kwargs,
                )
            )
        if len(parts) == 1:
            return parts[0]
        return hf_datasets.concatenate_datasets(parts)
