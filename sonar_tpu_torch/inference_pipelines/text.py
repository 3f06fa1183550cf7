"""Text pipelines of the port (``sonar_tpu.inference_pipelines.text``).

``TorchTextEncoder`` is the counterpart of ``JitTextEncoder``: it binds a
``SonarTextEncoder`` with its runtime parameter rewrites (fused QKV, int8
weights) on one device and encodes padded batches. PyTorch runs eagerly, so
there is no per-shape compile and no stacked dispatch; ``warmup`` builds the
CUDA kernels and runs each serving shape once.

``TextToEmbeddingModelPipeline.predict`` keeps the reference semantics
(length-sorted token-budget batching, truncation warning, order
restoration) and the static-shape batching of the JAX package, on the
port's copy of the host pipeline (``sonar_tpu_torch.data``).

``TextToTextModelPipeline`` (texts -> embeddings -> texts, or, given an
encoder-decoder model such as NLLB-200 MoE, texts -> the source's memory ->
texts) and
``EmbeddingToTextModelPipeline`` decode through ``TorchTextDecoder``, with
beam search or (``EmbeddingToTextModelPipeline.predict(sampler=...)``) top-p
/ top-k sampling; ``quantize=True`` decodes with int8 weights.

Every entry point runs on the GPU unless it is given ``device="cpu"``
(``sonar_tpu_torch.device``). ``TorchTextEncoder(mesh=...)`` runs over a
``parallel.mesh.Mesh``: every rank takes the global batch and returns the
whole result.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Iterable, List, Optional, Sequence, Union
import warnings

import numpy as np
from sonar_tpu_torch.data.batcher import StaticShapeBatcher
from sonar_tpu_torch.data.collate import (
    Collater,
    DEFAULT_LEN_BUCKETS,
    SequenceBatch,
    round_up_pow2,
)
from sonar_tpu_torch.data.pipeline import read_iterator, read_sequence, read_text
from sonar_tpu_torch.device import upload
from sonar_tpu_torch.inference_pipelines.utils import add_progress_bar
from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder
from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.parallel.mesh import Mesh
from sonar_tpu_torch.runtime import (
    ENCODER_ROWS,
    Counters,
    ModelRuntime,
    restore,
    split_rows,
    stream_in_window,
)
from sonar_tpu_torch.utils.profiling import span
import torch


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


class TorchTextEncoder(ModelRuntime):
    """A ``SonarTextEncoder`` bound for serving on one device.

    ``fuse_qkv`` concatenates each self-attention's q/k/v projections into
    one [D, 3D] projection; ``quantize`` stores the linear weights as int8
    with per-output-channel scales (the int8 serving mode). Both are
    runtime copies; the checkpoint layout is unchanged. ``device=None``
    means the GPU.

    ``mesh`` (a ``parallel.mesh.Mesh``, the counterpart of
    ``JitTextEncoder``'s; ``SINGLE_MESH``, this process alone, when None)
    holds this rank's slice of the weights (``shard_params``). Every rank
    takes the global batch: the rows are padded to a multiple of ``data``
    (pad id 1, length 0, as in the JAX runtime), each rank encodes its data
    coordinate's rows with its share of the heads and FFN columns, and the
    rows are gathered over the data group. Under ``data`` alone every
    kernel gate stays as it is; under ``model > 1`` the whole-block int8
    kernels (#2, #3) are off and the attention kernels run on the rank's
    heads (``nn.transformer``).

    ``stats`` counts the batches it encodes and their tokens, true and
    padded.
    """

    def __init__(self, model: SonarTextEncoder, fuse_qkv: bool = True,
                 quantize: bool = False, device: Any = None, mesh: Optional[Mesh] = None):
        params: Params = model.params.tree()
        if fuse_qkv:
            from sonar_tpu_torch.nn.transformer import fuse_qkv as _fuse

            params = _fuse(params)
        super().__init__(model, params, quantize, device, mesh)
        self.stats = Counters("batches", "true_tokens", "padded_tokens",
                              true="true_tokens", padded="padded_tokens")

    @property
    def max_source_len(self) -> int:
        return self.model.max_source_len

    def _encode(self, seqs: np.ndarray, lens: np.ndarray) -> torch.Tensor:
        """The embeddings of the global batch's rows, on the device."""
        rows = len(seqs)
        seqs = split_rows(np.asarray(seqs), self.mesh, ENCODER_ROWS, fill=1)
        lens = split_rows(np.asarray(lens), self.mesh, ENCODER_ROWS)
        with span("runtime.upload"):
            seqs_t = upload(torch.from_numpy(np.ascontiguousarray(seqs, np.int32)), self.device)
            lens_t = upload(torch.from_numpy(np.ascontiguousarray(lens, np.int32)), self.device)
        with self.scope():
            return self.gather(self.model(seqs_t, lens_t).sentence_embeddings, rows)

    def warmup(self, len_buckets: Optional[Sequence[int]] = None,
               tokens_per_batch: int = 8192) -> int:
        """Run one dummy batch per static serving shape (this builds the CUDA
        kernels on first use); returns the number of shapes."""
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
        tokens = int(np.asarray(batch.seq_lens)[: batch.true_batch].sum())
        self.stats.add(batches=1, true_tokens=tokens, padded_tokens=np.prod(batch.seqs.shape))
        with span("runtime.enqueue", rows=batch.true_batch, length=batch.seqs.shape[1],
                  tokens=tokens):
            emb = self._encode(batch.seqs, batch.seq_lens)[: batch.true_batch]
        return self.to_host(emb) if materialize else emb

    def encode_batches(self, batches: List[SequenceBatch]) -> List[np.ndarray]:
        """Encode many batches: all are enqueued on the device before the
        first result is copied out."""
        return self.encode_batches_iter(batches, max_pending=len(batches))

    def encode_batches_iter(self, batch_iter: Iterable[SequenceBatch],
                            max_pending: int = 64) -> List[np.ndarray]:
        """Streaming ``encode_batches``: each batch is enqueued as it arrives
        from a (typically prefetch-threaded) iterator; at most
        ``max_pending`` results wait on the device, oldest copied out first.
        Returns per-batch embeddings in input order."""
        return list(stream_in_window((self.encode_batch(b, materialize=False)
                                      for b in batch_iter), self.to_host, max_pending))


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
    """Tokenize stage: the batched native path when the encoder has one,
    a ``pipeline.tokenize`` span a chunk of 1,024 sentences."""
    encode_batch = getattr(tokenizer_encoder, "encode_batch", None)
    if encode_batch is None:
        return builder.map(tokenizer_encoder)

    def tokenize(texts: List[str]) -> List[List[int]]:
        with span("pipeline.tokenize", sentences=len(texts)) as s:
            ids = encode_batch(texts)
            if s:
                s.set(tokens=sum(map(len, ids)))
        return ids

    return builder.map_batched(tokenize, batch_size=1024)


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

        with span("pipeline.predict"):
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
                with span("pipeline.restore") as s:
                    out = restore(embs, np.concatenate(positions))
                    s.set(rows=len(out))
                    return out

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
            with span("pipeline.restore") as s:
                embeddings = restore(results, sorting_index)
                s.set(rows=len(embeddings))
            return embeddings


class TextToTextModelPipeline:
    """Texts -> translated texts through the 1024-d embedding bottleneck, or
    through an encoder-decoder model's sequence memory: an ``NllbMoeModel``
    (or its ``TorchEncoderDecoder``) given as the encoder, and as the
    decoder or None, is both."""

    def __init__(self, encoder: Union[str, TorchTextEncoder, SonarTextEncoder, Any],
                 decoder: Any, tokenizer: Any, device: Any = None, dtype: Any = None,
                 quantize: bool = False) -> None:
        both = _resolve_encoder_decoder(encoder, decoder, device)
        if both is not None:
            self.model = self.decoder = both
        else:
            self.model = _resolve_encoder(encoder, dtype, device)
            self.decoder = _resolve_decoder(decoder, dtype, quantize=quantize, device=device)
        self.tokenizer = _resolve_tokenizer(tokenizer)

    def warmup(self, batch_size: int = 5, target_lang: Optional[str] = None,
               **generator_kwargs: Any) -> int:
        """Run the encoder at every length bucket of ``predict``'s padded
        batch and one beam decode at each padded batch size up to
        ``batch_size``'s (this builds the CUDA kernels and captures each
        size's beam program); returns the number of shapes run."""
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig

        gen_config = BeamSearchConfig.from_kwargs(self.decoder.max_target_len,
                                                  **generator_kwargs)
        b_pad = round_up_pow2(batch_size)
        pad = self.tokenizer.vocab_info.pad_idx
        n = 0
        for bucket in DEFAULT_LEN_BUCKETS:
            if bucket > self.model.max_source_len:
                break
            self.model.encode_batch(SequenceBatch(
                seqs=np.full((b_pad, bucket), pad, np.int32),
                seq_lens=np.full((b_pad,), bucket, np.int32), true_batch=b_pad,
            ), materialize=False)
            n += 1
        from sonar_tpu_torch.generation.decoder_runtime import MEMORY_BUCKETS

        memory_len = MEMORY_BUCKETS[0] if self.model is self.decoder else 1
        return n + self.decoder.warmup(gen_config, prefix_len=_prefix_len(self.tokenizer,
                                                                           target_lang),
                                       batch_sizes=_padded_sizes(batch_size),
                                       memory_len=memory_len)

    def predict(self, input: Union[str, Path, Sequence[str]], source_lang: str,
                target_lang: str, batch_size: int = 5, progress_bar: bool = False,
                **generator_kwargs: Any) -> List[str]:
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
        from sonar_tpu_torch.generation.text_converter import TextTranslator

        gen_config = BeamSearchConfig.from_kwargs(self.decoder.max_target_len,
                                                  **generator_kwargs)
        translator = TextTranslator(self.model, self.decoder, self.tokenizer, source_lang,
                                    target_lang, gen_config)
        order = None
        if isinstance(input, (str, Path)):
            builder = read_text(Path(input))
        else:
            # A list is translated sorted by length, as fairseq batches a
            # translation job: a batch's sources pad to the bucket of
            # sources of about one length. The order is restored below.
            texts = list(input)
            order = np.argsort([len(s) for s in texts], kind="stable")
            builder = read_sequence([texts[i] for i in order])
        # Up to 2 batches in flight: batch i + 1's tokenizing and dispatches
        # overlap batch i's decode, and batch i's materialize and
        # detokenizing batch i + 1's compute.
        iterable = translator.translate_stream(iter(builder.bucket(batch_size).and_return()))
        if progress_bar:
            iterable = add_progress_bar(iterable, inputs=input, batch_size=batch_size)
        with span("pipeline.predict"):
            out = [x for y in iterable for x in y]
        if order is None:
            return out
        restored: List[str] = [""] * len(out)
        for k, i in enumerate(order):
            restored[i] = out[k]
        return restored


class EmbeddingToTextModelPipeline:
    """[N, model_dim] embeddings -> texts (beam search or sampling)."""

    def __init__(self, decoder: Any, tokenizer: Any, device: Any = None, dtype: Any = None,
                 quantize: bool = False) -> None:
        self.decoder = _resolve_decoder(decoder, dtype, quantize=quantize, device=device)
        self.tokenizer = _resolve_tokenizer(tokenizer)

    def warmup(self, batch_size: int = 5, target_lang: Optional[str] = None,
               **generator_kwargs: Any) -> int:
        """One beam decode at each padded batch size up to ``batch_size``'s
        and this generator config."""
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig

        gen_config = BeamSearchConfig.from_kwargs(self.decoder.max_target_len,
                                                  **generator_kwargs)
        return self.decoder.warmup(gen_config, prefix_len=_prefix_len(self.tokenizer, target_lang),
                                   batch_sizes=_padded_sizes(batch_size))

    def predict(self, inputs: Any, target_lang: str, batch_size: int = 5,
                progress_bar: bool = False, sampler: Any = None,
                **generator_kwargs: Any) -> List[str]:
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
        from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter

        gen_config = BeamSearchConfig.from_kwargs(self.decoder.max_target_len,
                                                  **generator_kwargs)
        converter = EmbeddingToTextConverter(self.decoder, self.tokenizer, target_lang,
                                             gen_config, sampler=sampler)
        if torch.is_tensor(inputs):
            inputs = inputs.float().cpu().numpy()
        inputs = np.asarray(inputs)
        pipeline = (read_sequence(list(inputs)).bucket(batch_size)
                    .map(lambda chunk: converter.batch_convert(np.stack(chunk))).and_return())
        iterable = pipeline
        if progress_bar:
            iterable = add_progress_bar(pipeline, inputs=inputs, batch_size=batch_size)
        with span("pipeline.predict", rows=len(inputs)):
            return [x for y in iterable for x in y]


def _padded_sizes(batch_size: int) -> tuple:
    """The batch sizes a decode of batches of up to ``batch_size`` rows pads
    to (powers of two: the tail batch may be any size), one decoder program
    each."""
    return tuple(1 << i for i in range(round_up_pow2(batch_size).bit_length()))


def _prefix_len(tokenizer: Any, target_lang: Optional[str]) -> int:
    lang = target_lang or getattr(tokenizer, "default_lang", None)
    if lang is None:
        return 2  # NLLB target prefix: [</s>, lang]
    return len(tokenizer.create_encoder(lang=lang, mode="target").prefix_indices)


def _resolve_encoder_decoder(encoder: Any, decoder: Any, device: Any = None) -> Any:
    """The one runtime of an encoder-decoder model given as ``encoder`` (and
    as ``decoder``, or None), or None for a SONAR encoder and decoder."""
    from sonar_tpu_torch.generation.decoder_runtime import TorchEncoderDecoder
    from sonar_tpu_torch.models.nllb_moe.model import NllbMoeModel

    if not isinstance(encoder, (NllbMoeModel, TorchEncoderDecoder)):
        return None
    if decoder is not None and decoder is not encoder:
        raise ValueError("an encoder-decoder model is its own decoder: pass it as both, "
                         "or the decoder as None")
    if isinstance(encoder, TorchEncoderDecoder):
        return encoder
    return TorchEncoderDecoder(encoder, device=device)


def _resolve_decoder(decoder: Any, dtype: Any = None, quantize: bool = False,
                     device: Any = None) -> Any:
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder

    if isinstance(decoder, TorchTextDecoder):
        return decoder
    if isinstance(decoder, str):
        from sonar_tpu_torch.assets.hub import load_text_decoder

        return load_text_decoder(decoder, dtype=dtype or torch.float32, device=device,
                                 quantize=quantize)
    if isinstance(decoder, ConditionalTransformerDecoder):
        return TorchTextDecoder(decoder, quantize=quantize, device=device)
    raise TypeError(
        "decoder must be a card name, TorchTextDecoder, or ConditionalTransformerDecoder")
