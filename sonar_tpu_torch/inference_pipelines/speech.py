"""Speech pipelines of the port (``sonar_tpu.inference_pipelines.speech``).

``TorchSpeechEncoder`` is the counterpart of ``JitSpeechEncoder``: it binds
a ``SonarSpeechEncoder`` (with int8 weights if asked) on one device. A batch of waveforms
is padded to its wave bucket and to a power-of-two row count, and fbank
(``ops.fbank``), the w2v-BERT frontend, the Conformer and the pooler all run
on that device. PyTorch runs eagerly: there is no per-bucket compile, and
``warmup`` builds the CUDA kernels and runs each bucket once.
``TorchSpeechEncoder.stats`` counts the clips and the Conformer positions
it encodes, true and padded.

``SpeechToEmbeddingModelPipeline.predict`` keeps the reference semantics
(wav paths or in-memory [T] / [C, T] 16 kHz arrays; in-memory clips batched
length-sorted and returned in input order) on the port's copy of the host
pipeline (``sonar_tpu_torch.data``); ``SpeechToEmbeddingPipeline`` is the
TSV-driven form. ``SpeechToTextModelPipeline`` and ``SpeechToTextPipeline``
decode the embeddings to text with the ``TorchTextDecoder``'s beam search,
the embeddings staying on the device. Every entry point runs on the GPU
unless it is given ``device="cpu"``. ``TorchSpeechEncoder(mesh=...)`` runs
over a ``parallel.mesh.Mesh``: every rank takes the global batch and
returns the whole result.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
from sonar_tpu_torch.data.audio import AudioDecoder, FileMapper
from sonar_tpu_torch.data.pipeline import DataPipelineBuilder, read_sequence, read_text
from sonar_tpu_torch.device import upload
from sonar_tpu_torch.inference_pipelines.utils import add_progress_bar
from sonar_tpu_torch.models.sonar_speech.model import SonarSpeechEncoder
from sonar_tpu_torch.ops.fbank import FbankConfig, batched_fbank, num_frames
from sonar_tpu_torch.parallel.mesh import Mesh
from sonar_tpu_torch.runtime import (
    POW2_ROWS,
    Counters,
    ModelRuntime,
    restore,
    row_split,
    stream_in_window,
)
from sonar_tpu_torch.utils.profiling import span
import torch

# Wave-length buckets (samples at 16 kHz), as in the JAX package: padding is
# wasted Conformer work, so the steps stay fine (typical waste under ~20%).
WAVE_BUCKETS = tuple(
    int(s * 16000)
    for s in (1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 10, 12, 15, 20, 25, 30, 40, 50, 60)
)


def _bucket_len(n: int) -> int:
    for b in WAVE_BUCKETS:
        if n <= b:
            return b
    return ((n + 16000 - 1) // 16000) * 16000


def _normalize_fbank_dtype(dt: Any) -> Optional[torch.dtype]:
    """Accept torch or numpy dtypes or their names; half precision maps to
    bf16, as in the JAX package."""
    if dt is None:
        return None
    name = getattr(dt, "__name__", None) or str(dt)
    name = name.replace("torch.", "").replace("jax.numpy.", "")
    if name in ("float16", "half", "bfloat16"):
        return torch.bfloat16
    if name in ("float32", "float"):
        return torch.float32
    raise ValueError(f"unsupported fbank_dtype: {dt!r}")


class TorchSpeechEncoder(ModelRuntime):
    """Waveform batches -> embeddings, fbank and encoder on one device.

    ``quantize`` stores the linear weights as int8 with per-output-channel
    scales (r_proj and the depthwise convolution stay in floating point).
    ``device=None`` means the GPU.

    ``mesh`` (a ``parallel.mesh.Mesh``; ``SINGLE_MESH``, this process
    alone, when None) holds this rank's slice of the weights
    (``shard_params``): the batch, padded to a power of two and then
    to a multiple of ``data``, is split over the data axis; each rank runs
    fbank and the encoder on its rows with its share of the heads and FFN
    columns, and the rows are gathered over the data group.

    ``stats`` counts over every ``encode_waveforms`` call: ``clips``,
    ``batches``, the clips' Conformer positions ``true_seq`` (the sum of
    their encoder lengths S_i, fbank frames // stride), ``true_seq_sq``
    (the sum of S_i^2: attention grows with it) and ``padded_seq`` (rows
    run on the device x the batch's padded S).
    """

    def __init__(self, model: SonarSpeechEncoder, fbank_config: Optional[FbankConfig] = None,
                 quantize: bool = False, fbank_dtype: Any = None, device: Any = None,
                 mesh: Optional[Mesh] = None):
        if fbank_config is None:
            # The mel-bin count follows the model's frontend, so every arch
            # (the 8-bin toy too) works through the pipeline.
            fbank_config = FbankConfig(num_mel_bins=model.config.frontend.num_fbank_channels)
        self.fbank_config = fbank_config
        self.fbank_dtype = _normalize_fbank_dtype(fbank_dtype)
        super().__init__(model, model.params.tree(), quantize, device, mesh)
        self.stats = Counters("clips", "batches", "true_seq", "true_seq_sq", "padded_seq",
                              true="true_seq", padded="padded_seq")

    def warmup(self, batch_size: int = 3, max_wave_len: int = 160000) -> int:
        """Encode one silent batch per ``WAVE_BUCKETS`` entry up to
        ``max_wave_len`` (this builds the CUDA kernels on first use); returns
        the number of buckets."""
        n = 0
        for b in WAVE_BUCKETS:
            if b > max_wave_len:
                break
            self.encode_waveforms([np.zeros((b,), np.float32)] * batch_size, materialize=False)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return n

    def encode_waveforms(self, waves: List[np.ndarray], materialize: bool = True) -> Any:
        """List of [T] float32 mono waveforms -> [N, model_dim] fp32 numpy;
        ``materialize=False`` keeps the embeddings on the device.

        Spans: ``pipeline.batch`` (the host pads the clips into their wave
        bucket: ``rows``, ``padded_rows`` run on the device, ``samples`` a
        row), ``runtime.upload``, ``runtime.fbank``, ``runtime.enqueue``
        (the encoder's launches: ``rows`` run, ``length`` the padded S) and
        ``runtime.copy_out``."""
        b = len(waves)
        with span("pipeline.batch", rows=b) as s:
            max_t = _bucket_len(max(w.shape[0] for w in waves))
            b_pad, mine = row_split(b, self.mesh, POW2_ROWS)
            batch = np.zeros((b_pad, max_t), np.float32)
            lens = np.zeros((b_pad,), np.int32)
            for i, w in enumerate(waves):
                batch[i, : w.shape[0]] = w
                lens[i] = w.shape[0]
            s.set(padded_rows=b_pad, samples=max_t)
        cfg, stride = self.fbank_config, self.model.config.frontend.fbank_stride
        max_frames = num_frames(max_t, cfg)
        seq = max_frames // stride
        clip_seq = np.asarray([num_frames(int(n), cfg) // stride for n in lens[:b]], np.int64)
        self.stats.add(clips=b, batches=1, true_seq=clip_seq.sum(),
                       true_seq_sq=(clip_seq * clip_seq).sum(), padded_seq=b_pad * seq)
        with span("runtime.upload"):
            waves_t = upload(torch.from_numpy(batch[mine]), self.device)
            lens_t = upload(torch.from_numpy(lens[mine]), self.device)
        with self.scope():
            with span("runtime.fbank"):
                feats, frame_lens = batched_fbank(waves_t, lens_t, max_frames, cfg)
                if self.fbank_dtype is not None:
                    feats = feats.to(self.fbank_dtype)
            with span("runtime.enqueue", rows=b_pad, length=seq):
                emb = self.gather(self.model(feats, frame_lens).sentence_embeddings, b)
        return self.to_host(emb) if materialize else emb


def _resolve_speech_encoder(encoder: Any, fbank_dtype: Any = None,
                            device: Any = None) -> TorchSpeechEncoder:
    if isinstance(encoder, TorchSpeechEncoder):
        if fbank_dtype is not None:
            encoder.fbank_dtype = _normalize_fbank_dtype(fbank_dtype)
        return encoder
    if isinstance(encoder, str):
        from sonar_tpu_torch.assets.hub import load_speech_encoder

        enc = load_speech_encoder(encoder, device=device)
        enc.fbank_dtype = _normalize_fbank_dtype(fbank_dtype)
        return enc
    if isinstance(encoder, SonarSpeechEncoder):
        return TorchSpeechEncoder(encoder, fbank_dtype=fbank_dtype, device=device)
    raise TypeError("encoder must be a card name, TorchSpeechEncoder, or SonarSpeechEncoder")


def _to_mono_wave(decoded: dict) -> np.ndarray:
    """Decoded audio -> mono 16 kHz float32 (channels averaged; other rates
    resampled polyphase on the host)."""
    wave = np.asarray(decoded["waveform"], np.float32)
    if wave.ndim == 2:
        wave = wave.mean(axis=1) if wave.shape[1] > 1 else wave[:, 0]
    rate = float(decoded.get("sample_rate", 16000.0))
    if rate != 16000.0:
        from scipy.signal import resample_poly

        frac = Fraction(16000, int(rate)).limit_denominator(1000)
        wave = resample_poly(wave, frac.numerator, frac.denominator).astype(np.float32)
    return wave


class SpeechModelPipelineInterface:
    """Shared audio decoding of the speech pipelines."""

    def __init__(self):
        self.audio_decoder = AudioDecoder()

    def _decode_audio(self, inp: Any) -> np.ndarray:
        if isinstance(inp, torch.Tensor):
            inp = inp.detach().float().cpu().numpy()
        if isinstance(inp, np.ndarray):
            return _to_mono_wave(self.audio_decoder(inp))
        return _to_mono_wave(self.audio_decoder(Path(str(inp))))


class SpeechToEmbeddingModelPipeline(SpeechModelPipelineInterface):
    """Waveforms or wav paths -> [N, model_dim] float32 embeddings."""

    def __init__(self, encoder: Union[str, TorchSpeechEncoder, SonarSpeechEncoder],
                 device: Any = None, fbank_dtype: Any = None) -> None:
        super().__init__()
        self.model = _resolve_speech_encoder(encoder, fbank_dtype=fbank_dtype, device=device)

    def warmup(self, batch_size: int = 3, max_wave_len: int = 160000) -> int:
        return self.model.warmup(batch_size=batch_size, max_wave_len=max_wave_len)

    def predict(
        self,
        input: Sequence,
        batch_size: int = 3,
        n_parallel: int = 1,
        pad_idx: int = 0,
        n_prefetched_batches: int = 2,
        progress_bar: bool = False,
    ) -> np.ndarray:
        items = list(input)
        with span("pipeline.predict", clips=len(items)):
            # In-memory clips are batched length-sorted (each batch pads to
            # its longest clip's bucket), then returned in input order;
            # paths stay in arrival order (their durations are unknown
            # before decoding).
            sorting_index = None
            if items and all(hasattr(w, "shape") for w in items):
                sorting_index = np.argsort([int(w.shape[-1]) for w in items], kind="stable")
                items = [items[i] for i in sorting_index]
            pipeline = (
                read_sequence(items)
                .map(self._decode_audio, num_parallel_calls=n_parallel)
                .bucket(batch_size)
                .prefetch(n_prefetched_batches)
                .map(self.model.encode_waveforms)
                .and_return()
            )
            iterable = pipeline
            if progress_bar:
                iterable = add_progress_bar(pipeline, inputs=items, batch_size=batch_size)
            results = list(iter(iterable))
            if not results:
                return np.zeros((0, self.model.model_dim), np.float32)
            return restore(results, sorting_index)


class SpeechToTextModelPipeline(SpeechModelPipelineInterface):
    """Waveforms or wav paths -> texts through the embedding bottleneck."""

    def __init__(self, encoder: Union[str, TorchSpeechEncoder, SonarSpeechEncoder],
                 decoder: Any, tokenizer: Any, device: Any = None,
                 fbank_dtype: Any = None) -> None:
        super().__init__()
        from sonar_tpu_torch.inference_pipelines.text import _resolve_decoder, _resolve_tokenizer

        self.model = _resolve_speech_encoder(encoder, fbank_dtype=fbank_dtype, device=device)
        self.decoder = _resolve_decoder(decoder, device=device)
        self.tokenizer = _resolve_tokenizer(tokenizer)

    def predict(
        self,
        input: Sequence,
        target_lang: str,
        batch_size: int = 3,
        n_parallel: int = 1,
        pad_idx: int = 0,
        n_prefetched_batches: int = 2,
        progress_bar: bool = False,
        **generator_kwargs: Any,
    ) -> List[str]:
        """Clips in arrival order, ``batch_size`` at a time: each batch is
        encoded and its embeddings go, still on the device, into the beam
        search, with up to 2 batches in flight (``runtime.stream_in_window``):
        batch i + 1's fbank, encode and decode dispatch run while batch i
        decodes."""
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
        from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter

        gen_config = BeamSearchConfig.from_kwargs(self.decoder.max_target_len,
                                                  **generator_kwargs)
        converter = EmbeddingToTextConverter(self.decoder, self.tokenizer, target_lang,
                                             gen_config)

        def dispatch(waves: List[np.ndarray]) -> Any:
            return converter.dispatch_convert(self.model.encode_waveforms(waves,
                                                                          materialize=False))

        pipeline = (
            read_sequence(list(input))
            .map(self._decode_audio, num_parallel_calls=n_parallel)
            .bucket(batch_size)
            .prefetch(n_prefetched_batches)
            .map(dispatch)
            .and_return()
        )
        iterable = stream_in_window(iter(pipeline), converter.finish_convert)
        if progress_bar:
            iterable = add_progress_bar(iterable, inputs=input, batch_size=batch_size)
        return [x for y in iterable for x in y]


# -- TSV-driven builders --------------------------------------------------------------


@dataclass
class SpeechInferenceParams:
    data_file: Path
    audio_root_dir: Path
    audio_path_index: int
    batch_size: int
    fbank_dtype: object = None
    target_lang: Optional[str] = None
    pad_idx: int = 0
    device: object = None
    n_parallel: int = 4
    n_prefetched_batches: int = 4


class AudioToFbankDataPipelineBuilder:
    """TSV -> decoded waveform batches (fbank runs on the device downstream)."""

    def prebuild_pipeline(self, context: SpeechInferenceParams) -> DataPipelineBuilder:
        mapper = FileMapper(root_dir=context.audio_root_dir, cached_fd_count=10)
        decoder = AudioDecoder()

        def split_tsv(line: str) -> dict:
            return {"audio": line.split("\t")[context.audio_path_index]}

        def decode(entry: dict) -> np.ndarray:
            return _to_mono_wave(decoder(entry["data"]))

        return (
            read_text(context.data_file)
            .skip(1)
            .map(split_tsv)
            .map(mapper, selector="audio", num_parallel_calls=context.n_parallel)
            .map(lambda item: decode(item["audio"]), num_parallel_calls=context.n_parallel)
            .bucket(context.batch_size)
            .prefetch(context.n_prefetched_batches)
        )


class SpeechToEmbeddingPipeline:
    def __init__(self, model: Union[str, TorchSpeechEncoder, SonarSpeechEncoder],
                 device: Any = None) -> None:
        self.model = _resolve_speech_encoder(model, device=device)
        self._audio_builder = AudioToFbankDataPipelineBuilder()

    @classmethod
    def load_model_from_name(cls, encoder_name: str) -> "SpeechToEmbeddingPipeline":
        return cls(encoder_name)

    def prebuild_pipeline(self, context: SpeechInferenceParams) -> DataPipelineBuilder:
        return self._audio_builder.prebuild_pipeline(context).map(self.model.encode_waveforms)

    def build_pipeline(self, context: SpeechInferenceParams) -> Any:
        return self.prebuild_pipeline(context).and_return()


class SpeechToTextPipeline:
    """TSV of audio paths -> texts: the speech encoder and the text decoder
    (a ``(encoder, decoder)`` pair) with the beam search's defaults."""

    def __init__(self, model: Tuple[Any, Any], tokenizer: Any, device: Any = None) -> None:
        from sonar_tpu_torch.inference_pipelines.text import _resolve_decoder, _resolve_tokenizer

        encoder, decoder = model
        self.encoder = _resolve_speech_encoder(encoder, device=device)
        self.decoder = _resolve_decoder(decoder, device=device)
        self.tokenizer = _resolve_tokenizer(tokenizer)
        self._audio_builder = AudioToFbankDataPipelineBuilder()

    @classmethod
    def load_model_from_name(cls, encoder_name: str, decoder_name: str,
                             device: Any = None) -> "SpeechToTextPipeline":
        from sonar_tpu_torch.assets.hub import load_tokenizer
        from sonar_tpu_torch.assets.store import default_store

        card = default_store().model_card(decoder_name)
        return cls((encoder_name, decoder_name), load_tokenizer(card.tokenizer or decoder_name),
                   device=device)

    def prebuild_pipeline(self, context: SpeechInferenceParams) -> DataPipelineBuilder:
        from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
        from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter

        if context.target_lang is None:
            raise ValueError("SpeechToTextPipeline needs context.target_lang")
        converter = EmbeddingToTextConverter(
            self.decoder, self.tokenizer, context.target_lang,
            BeamSearchConfig.from_kwargs(self.decoder.max_target_len))

        def generate(waves: List[np.ndarray]) -> List[str]:
            return converter.batch_convert(self.encoder.encode_waveforms(waves, materialize=False))

        return self._audio_builder.prebuild_pipeline(context).map(generate)

    def build_pipeline(self, context: SpeechInferenceParams) -> Any:
        return self.prebuild_pipeline(context).and_return()
