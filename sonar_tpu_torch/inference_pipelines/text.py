"""Text -> embedding pipeline of the port (``sonar_tpu.inference_pipelines.text``).

``TorchTextEncoder`` is the counterpart of ``JitTextEncoder``: it binds a
``SonarTextEncoder`` with its runtime parameter rewrites (fused QKV, int8
weights) on one device and encodes padded batches. PyTorch runs eagerly, so
there is no per-shape compile and no stacked dispatch; ``warmup`` builds the
CUDA kernels and runs each serving shape once.

``TextToEmbeddingModelPipeline.predict`` keeps the reference semantics
(length-sorted token-budget batching, truncation warning, order
restoration) and the static-shape batching of the JAX package, on the
shared host pipeline (``sonar_tpu.data``).
"""

from __future__ import annotations

from collections import deque
import math
from pathlib import Path
import threading
from typing import Any, Iterable, List, Optional, Sequence, Sized, Union
import warnings

import numpy as np
from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder
from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch

from sonar_tpu.data.collate import Collater, DEFAULT_LEN_BUCKETS, SequenceBatch
from sonar_tpu.data.pipeline import read_iterator, read_sequence, read_text


def _len_buckets_for(max_len: int) -> tuple:
    return tuple(b for b in DEFAULT_LEN_BUCKETS if b < max_len) + (max_len,)


# Length buckets of static batching, as in the JAX package.
STATIC_LEN_BUCKETS = (
    8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 22, 24, 26, 28, 30,
    32, 36, 40, 48, 56, 64, 80, 128, 192, 256, 384, 512,
)


def _static_len_buckets_for(max_len: int) -> tuple:
    return tuple(b for b in STATIC_LEN_BUCKETS if b < max_len) + (max_len,)


# Most encoded batches left on the device before the oldest is copied out.
_STATIC_ENCODE_WINDOW = 64


class EncodeStats:
    """Thread-safe padded-vs-true token accounting over every encode call."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.batches = 0
        self.true_tokens = 0
        self.padded_tokens = 0

    def add(self, batch: SequenceBatch) -> None:
        padded = int(np.prod(batch.seqs.shape))
        true = int(np.asarray(batch.seq_lens)[: batch.true_batch].sum())
        with self._lock:
            self.batches += 1
            self.true_tokens += true
            self.padded_tokens += padded

    def snapshot(self) -> dict:
        with self._lock:
            b, t, p = self.batches, self.true_tokens, self.padded_tokens
        return {
            "batches": b,
            "true_tokens": t,
            "padded_tokens": p,
            "padding_waste": round(1.0 - t / p, 4) if p else 0.0,
        }


def _model_device(model: SonarTextEncoder) -> torch.device:
    return next(iter(model.buffers())).device


class TorchTextEncoder:
    """A ``SonarTextEncoder`` bound for serving on one device.

    ``fuse_qkv`` concatenates each self-attention's q/k/v projections into
    one [D, 3D] projection; ``quantize`` stores the linear weights as int8
    with per-output-channel scales (the int8 serving mode). Both are
    runtime copies; the checkpoint layout is unchanged.
    """

    def __init__(self, model: SonarTextEncoder, fuse_qkv: bool = True,
                 quantize: bool = False, device: Any = None):
        self.device = torch.device(device) if device is not None else _model_device(model)
        params: Params = model.params.tree()
        if fuse_qkv:
            from sonar_tpu_torch.nn.transformer import fuse_qkv as _fuse

            params = _fuse(params)
        if quantize:
            from sonar_tpu_torch.ops.quantization import quantize_params_int8

            params = quantize_params_int8(params)
        self.model = SonarTextEncoder(model.config, params, dtype=model.dtype).to(self.device)
        self.stats = EncodeStats()

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def model_dim(self) -> int:
        return self.model.config.model_dim

    @property
    def max_source_len(self) -> int:
        return self.model.max_source_len

    def _encode(self, seqs: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        seqs_t = torch.from_numpy(np.ascontiguousarray(seqs, np.int32)).to(self.device)
        lens_t = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(self.device)
        with torch.inference_mode(), matmul_precision_for(self.dtype):
            return self.model(seqs_t, lens_t).sentence_embeddings

    @staticmethod
    def _to_host(emb: torch.Tensor) -> np.ndarray:
        return emb.float().cpu().numpy()

    def warmup(self, len_buckets: Optional[Sequence[int]] = None,
               tokens_per_batch: int = 8192) -> int:
        """Run one dummy batch per static serving shape (this builds the CUDA
        kernels on first use); returns the number of shapes."""
        from sonar_tpu.data.batcher import StaticShapeBatcher

        if len_buckets is None:
            len_buckets = _static_len_buckets_for(self.max_source_len)
        batcher = StaticShapeBatcher(pad_value=1, len_buckets=len_buckets,
                                     tokens_per_batch=tokens_per_batch)
        for bucket in batcher.len_buckets:
            rows = batcher.batch_size_for(bucket)
            self._encode(np.full((rows, bucket), 4, np.int32),
                         np.full((rows,), bucket, np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(batcher.len_buckets)

    def encode_batch(self, batch: SequenceBatch, materialize: bool = True) -> Any:
        """Embeddings of the batch's real rows; ``materialize=False`` keeps
        them on the device."""
        self.stats.add(batch)
        emb = self._encode(batch.seqs, batch.seq_lens)[: batch.true_batch]
        return self._to_host(emb) if materialize else emb

    def encode_batches(self, batches: List[SequenceBatch]) -> List[np.ndarray]:
        """Encode many batches: all are enqueued on the device before the
        first result is copied out."""
        pending = [self.encode_batch(b, materialize=False) for b in batches]
        return [self._to_host(e) for e in pending]

    def encode_batches_iter(self, batch_iter: Iterable[SequenceBatch],
                            max_pending: int = 64) -> List[np.ndarray]:
        """Streaming ``encode_batches``: each batch is enqueued as it arrives
        from a (typically prefetch-threaded) iterator; at most
        ``max_pending`` results wait on the device, oldest copied out first.
        Returns per-batch embeddings in input order."""
        out: List[np.ndarray] = []
        pending: deque = deque()
        for b in batch_iter:
            pending.append(self.encode_batch(b, materialize=False))
            while len(pending) > max_pending:
                out.append(self._to_host(pending.popleft()))
        out.extend(self._to_host(e) for e in pending)
        return out


def _resolve_encoder(encoder: Any, dtype: Any = None, device: Any = None) -> TorchTextEncoder:
    if isinstance(encoder, TorchTextEncoder):
        return encoder
    if isinstance(encoder, str):
        from sonar_tpu_torch.assets.hub import load_text_encoder

        return load_text_encoder(encoder, dtype=dtype or torch.float32, device=device)
    if isinstance(encoder, SonarTextEncoder):
        return TorchTextEncoder(encoder, device=device)
    raise TypeError("encoder must be a card name, TorchTextEncoder, or SonarTextEncoder")


def _resolve_tokenizer(tokenizer: Any) -> Any:
    if isinstance(tokenizer, str):
        from sonar_tpu_torch.assets.hub import load_tokenizer

        return load_tokenizer(tokenizer)
    return tokenizer


def _map_tokenize(builder: Any, tokenizer_encoder: Any) -> Any:
    """Tokenize stage: the batched native path when the encoder has one."""
    encode_batch = getattr(tokenizer_encoder, "encode_batch", None)
    if encode_batch is None:
        return builder.map(tokenizer_encoder)
    return builder.map_batched(encode_batch, batch_size=1024)


def add_progress_bar(iterable: Iterable, inputs: Optional[Sized] = None,
                     batch_size: Optional[int] = None) -> Iterable:
    """Wrap with tqdm when it is installed."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return iterable
    total = None
    if inputs is not None and batch_size:
        try:
            total = math.ceil(len(inputs) / batch_size)
        except TypeError:
            total = None
    return tqdm(iterable, total=total)


class TextToEmbeddingModelPipeline:
    """Texts -> [N, model_dim] float32 sentence embeddings."""

    def __init__(self, encoder: Union[str, TorchTextEncoder, SonarTextEncoder],
                 tokenizer: Any, device: Any = None, dtype: Any = None) -> None:
        self.model = _resolve_encoder(encoder, dtype, device)
        self.tokenizer = _resolve_tokenizer(tokenizer)
        self.device = self.model.device

    def predict(
        self,
        input: Union[str, Path, Sequence[str]],
        source_lang: str,
        batch_size: Optional[int] = 5,
        batch_max_tokens: Optional[int] = None,
        max_seq_len: Optional[int] = None,
        progress_bar: bool = False,
        target_device: Any = None,
        batching: str = "dynamic",
    ) -> np.ndarray:
        """``batching="dynamic"`` keeps the reference's token-budget dynamic
        bucketing; ``"static"`` goes through ``StaticShapeBatcher``: fixed
        (batch, len) shapes per length bucket, 8192 tokens per batch by
        default."""
        if batching not in ("dynamic", "static"):
            raise ValueError(f"unknown batching mode: {batching!r}")
        if batch_max_tokens is None and batch_size is None:
            raise ValueError(
                "at least one of `batch_size` or `batch_max_tokens` should be provided"
            )
        if batch_max_tokens is not None and batch_max_tokens <= 0:
            raise ValueError("`batch_max_tokens` should be strictly positive")
        if batch_size is not None and batch_size <= 0:
            raise ValueError("`batch_size` should be strictly positive")

        tokenizer_encoder = self.tokenizer.create_encoder(lang=source_lang)
        model_max_len = self.model.max_source_len
        if max_seq_len is None:
            max_seq_len = model_max_len
        elif max_seq_len > model_max_len:
            raise ValueError(
                f"max_seq_len cannot be larger than max_seq_len of the encoder model: {model_max_len}"
            )

        n_truncated = 0

        def truncate(ids: List[int]) -> List[int]:
            nonlocal n_truncated
            if len(ids) > max_seq_len:
                n_truncated += 1
                return ids[:max_seq_len]
            return ids

        def warn_truncated() -> None:
            if n_truncated:
                warnings.warn(
                    f"For {n_truncated} input tensors for SONAR text encoder, "
                    f"the length was truncated to {max_seq_len} elements."
                )

        empty = np.zeros((0, self.model.model_dim), np.float32)
        if isinstance(input, (str, Path)):
            builder = read_text(Path(input))
            sorting_index = None
        elif len(input) == 0:
            return empty
        elif batching == "static":
            # Length buckets group by size already; order is restored from
            # the batcher's input positions.
            sorting_index = None
            builder = read_sequence(list(input))
        else:
            sorting_index = np.argsort([len(s) for s in input], kind="stable")
            builder = read_sequence([input[i] for i in sorting_index])

        pad_idx = self.tokenizer.vocab_info.pad_idx

        if batching == "static":
            from sonar_tpu.data.batcher import StaticShapeBatcher

            batcher = StaticShapeBatcher(
                pad_value=pad_idx,
                len_buckets=_static_len_buckets_for(max_seq_len),
                tokens_per_batch=batch_max_tokens or 8192,
            )
            tokens = _map_tokenize(builder, tokenizer_encoder).map(truncate).and_return()
            # A prefetch thread tokenizes, buckets and pads while batches are
            # encoded on the device.
            it = iter(
                read_iterator(lambda: batcher.batches(iter(tokens), yield_indices=True))
                .prefetch(64)
                .and_return()
            )
            positions = []

            def batches_only():
                for b, pos in it:
                    positions.append(pos)
                    yield b

            embs = self.model.encode_batches_iter(
                batches_only(), max_pending=_STATIC_ENCODE_WINDOW
            )
            warn_truncated()
            if not embs:
                return empty
            out = np.concatenate(embs, axis=0)
            return out[np.argsort(np.concatenate(positions), kind="stable")]

        collater = Collater(pad_idx, len_buckets=_len_buckets_for(max_seq_len))
        pipeline = (
            _map_tokenize(builder, tokenizer_encoder)
            .map(truncate)
            .dynamic_bucket(
                batch_max_tokens or 2**31,
                len,
                min_num_examples=1,
                max_num_examples=batch_size or 20_000,
                drop_remainder=False,
            )
            .map(collater)
            .prefetch(2)
            .map(self.model.encode_batch)
            .and_return()
        )
        iterable = pipeline
        if progress_bar:
            iterable = add_progress_bar(
                pipeline, inputs=input,
                batch_size=batch_size if batch_max_tokens is None else None,
            )
        results = list(iter(iterable))
        warn_truncated()
        if not results:
            return empty
        embeddings = np.concatenate(results, axis=0)
        if sorting_index is not None:
            embeddings = embeddings[np.argsort(sorting_index, kind="stable")]
        return embeddings
