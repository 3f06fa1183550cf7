"""Weights for the port's text encoder, speech encoder, text decoder and
the BLASER, MuTox and LASER2 heads.

All routes produce the JAX package's parameter layout (linear kernels
[in, out], per-layer tensors stacked on a leading L axis) as numpy arrays,
then load it into ``SonarTextEncoder``, ``SonarSpeechEncoder`` or
``ConditionalTransformerDecoder``:

- ``text_encoder_from_numpy`` / ``speech_encoder_from_numpy`` /
  ``text_decoder_from_numpy``: the JAX package's pytree (from
  ``init_params`` or the checkpoint converters, as numpy) -> the port's
  module computing the same function;
- ``init_text_encoder_params`` / ``init_speech_encoder_params`` /
  ``init_text_decoder_params``: seeded numpy initialisers with the JAX
  package's distributions;
- ``load_text_encoder_checkpoint`` / ``load_speech_encoder_checkpoint`` /
  ``load_text_decoder_checkpoint``: a fairseq2 or fairseq1 ``.pt`` state
  dict -> the port's module, through the port's own copies of the key maps
  (``checkpoint``, ``checkpoint_speech``);
- ``blaser_from_numpy`` / ``mutox_from_numpy`` / ``laser2_from_numpy`` and
  the seeded ``init_blaser_params`` / ``init_mutox_params`` /
  ``init_laser2_params`` for the heads, whose checkpoints map through the
  models' ``*_params_from_torch``. The heads have no runtime around them,
  so their builders place them themselves: ``device=None`` is ``cuda``, as
  for every entry point, and the CPU takes ``device="cpu"``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
from sonar_tpu_torch.assets import checkpoint as ckpt
from sonar_tpu_torch.assets import checkpoint_speech
from sonar_tpu_torch.device import resolve_device
from sonar_tpu_torch.models.sonar_speech.config import SonarSpeechEncoderConfig
from sonar_tpu_torch.models.sonar_speech.model import SonarSpeechEncoder
from sonar_tpu_torch.models.sonar_text.config import SonarTextDecoderConfig, SonarTextEncoderConfig
from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder
from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
import torch


def _to_torch(node: Any, dtype: torch.dtype, device: Any) -> Any:
    if isinstance(node, dict):
        return {k: _to_torch(v, dtype, device) for k, v in node.items()}
    t = torch.tensor(np.asarray(node))
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def text_encoder_from_numpy(
    params: Dict[str, Any],
    config: SonarTextEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarTextEncoder:
    """The port's encoder holding ``params`` (a JAX-layout pytree of numpy
    arrays) and computing in ``dtype``. Floating-point parameters are
    stored in ``dtype``, as the JAX hub loads a checkpoint."""
    return SonarTextEncoder(config, _to_torch(params, dtype, device), dtype=dtype)


def _uniform(rng: np.random.Generator, shape: tuple, bound: float) -> np.ndarray:
    return ((rng.random(shape, dtype=np.float32) * 2.0 - 1.0) * bound).astype(np.float32)


def _init_linear(rng: np.random.Generator, n: Optional[int], in_dim: int, out_dim: int,
                 bias: bool = True) -> Dict[str, np.ndarray]:
    """Kaiming-uniform fan-in linear, stacked on a leading axis of ``n``
    layers (None: one layer)."""
    bound = math.sqrt(1.0 / in_dim)
    lead = () if n is None else (n,)
    kernel = np.empty(lead + (in_dim, out_dim), np.float32)
    b = np.empty(lead + (out_dim,), np.float32)
    for i in range(n or 1):  # one layer at a time bounds the temporaries
        at = () if n is None else (i,)
        kernel[at] = _uniform(rng, (in_dim, out_dim), math.sqrt(3.0) * bound)
        b[at] = _uniform(rng, (out_dim,), bound)
    return {"kernel": kernel, "bias": b} if bias else {"kernel": kernel}


def _init_ln(shape: tuple) -> Dict[str, np.ndarray]:
    return {"weight": np.ones(shape, np.float32), "bias": np.zeros(shape, np.float32)}


def _init_embedding(rng: np.random.Generator, rows: int, dim: int,
                    pad_idx: Optional[int]) -> np.ndarray:
    """N(0, dim^-0.5) with a zero pad row."""
    embed = rng.standard_normal((rows, dim), dtype=np.float32) * np.float32(dim ** -0.5)
    if pad_idx is not None:
        embed[pad_idx] = 0.0
    return embed


def _init_attn(rng: np.random.Generator, n: int, dim: int, kv_dim: int) -> Dict[str, Any]:
    return {"q_proj": _init_linear(rng, n, dim, dim),
            "k_proj": _init_linear(rng, n, kv_dim, dim),
            "v_proj": _init_linear(rng, n, kv_dim, dim),
            "output_proj": _init_linear(rng, n, dim, dim)}


def _init_decoder_layers(rng: np.random.Generator, n: int, dim: int, kv_dim: int,
                         ffn_dim: int) -> Dict[str, Any]:
    """``n`` stacked decoder layers: self-attention, cross-attention on a
    ``kv_dim`` memory, FFN, each with its LayerNorm."""
    return {
        "self_attn": _init_attn(rng, n, dim, dim),
        "self_attn_layer_norm": _init_ln((n, dim)),
        "encoder_decoder_attn": _init_attn(rng, n, dim, kv_dim),
        "encoder_decoder_attn_layer_norm": _init_ln((n, dim)),
        "ffn": {"inner_proj": _init_linear(rng, n, dim, ffn_dim),
                "output_proj": _init_linear(rng, n, ffn_dim, dim)},
        "ffn_layer_norm": _init_ln((n, dim)),
    }


def _init_pooler(rng: np.random.Generator, n: int, dim: int, kv_dim: int, ffn_dim: int,
                 embed_rows: int, pad_idx: int, proj_bias: bool,
                 final_ln: bool) -> Dict[str, Any]:
    """An ATTENTION pooler: ``n`` decoder layers, its BOS table, projection."""
    layers = _init_decoder_layers(rng, n, dim, kv_dim, ffn_dim)
    pooler: Dict[str, Any] = {
        "decoder_frontend": {"embed": {"weight": _init_embedding(rng, embed_rows, dim, pad_idx)}},
        "decoder": {"layers": layers},
        "projection_out": _init_linear(rng, None, dim, dim, bias=proj_bias),
    }
    if final_ln:
        pooler["decoder"]["layer_norm"] = _init_ln((dim,))
    return pooler


def init_text_encoder_params(config: SonarTextEncoderConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random pytree of ``config``'s shape, drawn with numpy.

    Same distributions as the JAX ``init_params`` (Kaiming-uniform fan-in
    linears, N(0, d^-0.5) embedding with a zero pad row, unit LayerNorms),
    not the same numbers.
    """
    rng = np.random.default_rng(seed)
    d, f, n = config.model_dim, config.ffn_inner_dim, config.num_encoder_layers
    layers = {
        "self_attn": {p: _init_linear(rng, n, d, d)
                      for p in ("q_proj", "k_proj", "v_proj", "output_proj")},
        "self_attn_layer_norm": _init_ln((n, d)),
        "ffn": {"inner_proj": _init_linear(rng, n, d, f), "output_proj": _init_linear(rng, n, f, d)},
        "ffn_layer_norm": _init_ln((n, d)),
    }
    params: Dict[str, Any] = {
        "encoder_frontend": {"embed": {"weight": _init_embedding(
            rng, config.vocab_info.size, d, config.vocab_info.pad_idx)}},
        "encoder": {"layers": layers},
        "layer_norm": _init_ln((d,)),
    }
    if config.learned_pos:
        rows = config.max_seq_len + ((config.vocab_info.pad_idx or 0) + 1
                                     if config._from_fairseq else 0)
        params["encoder_frontend"]["pos"] = {
            "weight": rng.standard_normal((rows, d), dtype=np.float32)}
    if config.normalize_before:
        params["encoder"]["layer_norm"] = _init_ln((d,))
    if config.pooling.lower() == "attention":
        emb = config.embedding_dim or d
        params["pooler"] = _init_pooler(
            rng, config.num_decoder_layers, emb, d, config.decoder_ffn_inner_dim or f,
            embed_rows=1, pad_idx=0, proj_bias=True, final_ln=config.normalize_before)
    return params


def init_speech_encoder_params(config: SonarSpeechEncoderConfig,
                               seed: int = 0) -> Dict[str, Any]:
    """Seeded random pytree of ``config``'s shape, drawn with numpy, with
    the JAX ``init_params`` distributions (not its numbers): Kaiming-uniform
    linears (r_proj and the pointwise convolutions unbiased), u_bias
    N(0, 0.02^2), v_bias 0, depthwise kernel N(0, 1/K), identity batch-norm
    statistics, unit LayerNorms, N(0, d^-0.5) pooler table with a zero pad
    row."""
    rng = np.random.default_rng(seed)
    c = config.conformer
    d, f, n, k = c.model_dim, c.ffn_inner_dim, c.num_layers, c.depthwise_kernel_size

    def ffn() -> Dict[str, Any]:
        return {"inner_proj": _init_linear(rng, n, d, f), "output_proj": _init_linear(rng, n, f, d)}

    u_bias = rng.standard_normal((n, c.num_heads, c.head_dim), dtype=np.float32)
    layers = {
        "ffn1_layer_norm": _init_ln((n, d)),
        "ffn1": ffn(),
        "self_attn_layer_norm": _init_ln((n, d)),
        "self_attn": {
            **{p: _init_linear(rng, n, d, d) for p in ("q_proj", "k_proj", "v_proj", "output_proj")},
            "sdpa": {
                "r_proj": _init_linear(rng, n, d, d, bias=False),
                "u_bias": u_bias * np.float32(0.02),
                "v_bias": np.zeros((n, c.num_heads, c.head_dim), np.float32),
            },
        },
        "conv_layer_norm": _init_ln((n, d)),
        "conv": {
            "pointwise_conv1": _init_linear(rng, n, d, 2 * d, bias=False),
            "depthwise_conv": {"kernel": rng.standard_normal((n, k, 1, d), dtype=np.float32)
                               * np.float32(1.0 / math.sqrt(k))},
            "batch_norm": {"weight": np.ones((n, d), np.float32),
                           "bias": np.zeros((n, d), np.float32),
                           "running_mean": np.zeros((n, d), np.float32),
                           "running_var": np.ones((n, d), np.float32)},
            "pointwise_conv2": _init_linear(rng, n, d, d, bias=False),
        },
        "ffn2_layer_norm": _init_ln((n, d)),
        "ffn2": ffn(),
        "layer_norm": _init_ln((n, d)),
    }
    feat = config.frontend.feature_dim
    return {
        "encoder_frontend": {"post_extract_layer_norm": _init_ln((feat,)),
                             "model_dim_proj": _init_linear(rng, None, feat, config.model_dim)},
        "encoder": {"layers": layers},
        "layer_norm": _init_ln((config.model_dim,)),
        "encoder_pooler": _init_pooler(
            rng, config.num_decoder_layers, config.model_dim, config.model_dim,
            config.ffn_inner_dim, embed_rows=config.model_dim, pad_idx=config.pad_idx,
            proj_bias=False, final_ln=config.decoder_norm_order == "pre"),
    }


def text_encoder_params_from_state(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Flat fairseq2 (or fairseq1) state dict -> the JAX-layout pytree
    (``checkpoint.text_encoder_params``)."""
    return ckpt.text_encoder_params(flat)


def load_text_encoder_checkpoint(
    path: Union[str, Path],
    config: SonarTextEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarTextEncoder:
    """A ``.pt`` text-encoder checkpoint -> the port's encoder, its
    floating-point parameters stored in ``dtype``."""
    params = text_encoder_params_from_state(ckpt.load_torch_state_dict(path))
    return text_encoder_from_numpy(params, config, dtype, device)


def speech_encoder_from_numpy(
    params: Dict[str, Any],
    config: SonarSpeechEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarSpeechEncoder:
    """The port's speech encoder holding ``params`` (a JAX-layout pytree of
    numpy arrays) and computing in ``dtype``; floating-point parameters are
    stored in ``dtype``, as the JAX hub loads a checkpoint."""
    return SonarSpeechEncoder(config, _to_torch(params, dtype, device), dtype=dtype)


def speech_encoder_params_from_state(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Flat fairseq1 (w2v-BERT) or fairseq2 speech state dict -> the
    JAX-layout pytree (``checkpoint_speech.speech_encoder_params``)."""
    return checkpoint_speech.speech_encoder_params(flat)


def load_speech_encoder_checkpoint(
    path: Union[str, Path],
    config: SonarSpeechEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarSpeechEncoder:
    """A ``.pt`` speech-encoder checkpoint -> the port's encoder, its
    floating-point parameters stored in ``dtype``."""
    params = speech_encoder_params_from_state(ckpt.load_torch_state_dict(path))
    return speech_encoder_from_numpy(params, config, dtype, device)


def text_decoder_from_numpy(
    params: Dict[str, Any],
    config: SonarTextDecoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> ConditionalTransformerDecoder:
    """The port's text decoder holding ``params`` (a JAX-layout pytree of
    numpy arrays) and computing in ``dtype``; floating-point parameters are
    stored in ``dtype``, as the JAX hub loads a checkpoint."""
    return ConditionalTransformerDecoder(config, _to_torch(params, dtype, device), dtype=dtype)


def init_text_decoder_params(config: SonarTextDecoderConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random pytree of ``config``'s shape, drawn with numpy, with the
    JAX ``init_params`` distributions (not its numbers): Kaiming-uniform
    linears, N(0, d^-0.5) embedding with a zero pad row (the tied output
    projection), unit LayerNorms."""
    rng = np.random.default_rng(seed)
    d = config.model_dim
    params: Dict[str, Any] = {
        "decoder_frontend": {"embed": {"weight": _init_embedding(
            rng, config.vocab_info.size, d, config.vocab_info.pad_idx)}},
        "decoder": {
            "layers": _init_decoder_layers(rng, config.num_decoder_layers, d,
                                           config.input_dim or d, config.ffn_inner_dim),
            "layer_norm": _init_ln((d,)),
        },
    }
    if config.learned_pos:
        params["decoder_frontend"]["pos"] = {
            "weight": rng.standard_normal((config.max_seq_len, d), dtype=np.float32)}
    return params


def load_text_decoder_checkpoint(
    path: Union[str, Path],
    config: SonarTextDecoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> ConditionalTransformerDecoder:
    """A ``.pt`` text-decoder checkpoint -> the port's decoder, its
    floating-point parameters stored in ``dtype``."""
    params = ckpt.text_decoder_params(ckpt.load_torch_state_dict(path))
    return text_decoder_from_numpy(params, config, dtype, device)


# -- heads ------------------------------------------------------------------------------


def _init_mlp(rng: np.random.Generator, dims: list) -> Dict[str, Any]:
    """Kaiming-uniform linears dims[0] -> dims[1] -> ..., keyed "0", "1", ..."""
    return {str(i): _init_linear(rng, None, dims[i], dims[i + 1]) for i in range(len(dims) - 1)}


def init_blaser_params(config: Any, seed: int = 0) -> Dict[str, Any]:
    """Seeded random BLASER MLP of ``config``'s shape (the JAX
    ``init_params`` distributions, drawn with numpy)."""
    dims = ([config.feature_dim] + [h for h in config.hidden_dims if h > 0]
            + [config.output_dim])
    return {"mlp": _init_mlp(np.random.default_rng(seed), dims)}


def blaser_from_numpy(params: Dict[str, Any], config: Any, device: Any = None) -> Any:
    """The port's BLASER holding ``params`` ({"mlp": ...}, numpy), in fp32
    on ``device`` (None: ``cuda``)."""
    from sonar_tpu_torch.models.blaser.model import BlaserModel

    return BlaserModel(config, _to_torch(params, torch.float32, resolve_device(device)))


def init_mutox_params(config: Any, seed: int = 0) -> Dict[str, Any]:
    """Seeded random MuTox classifier (1024 -> 512 -> 128 -> 1)."""
    from sonar_tpu_torch.models.mutox.model import MutoxClassifier

    dims = [config.input_size, *MutoxClassifier.HIDDEN, 1]
    return {"layers": _init_mlp(np.random.default_rng(seed), dims)}


def mutox_from_numpy(params: Dict[str, Any], config: Any, device: Any = None) -> Any:
    """The port's MuTox classifier holding ``params`` ({"layers": ...}), in
    fp32 on ``device`` (None: ``cuda``)."""
    from sonar_tpu_torch.models.mutox.model import MutoxClassifier

    return MutoxClassifier(config, _to_torch(params, torch.float32, resolve_device(device)))


def init_laser2_params(config: Any, seed: int = 0) -> Dict[str, Any]:
    """Seeded random LASER2 encoder with the JAX ``init_params``
    distributions: embedding N(0, 0.1^2) with a zero pad row, LSTM weights
    and biases uniform in +-1/sqrt(hidden), torch layout."""
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((config.vocabulary_size, config.model_dim),
                                dtype=np.float32) * np.float32(0.1)
    embed[config.pad_idx] = 0.0
    h, bound = config.hidden_size, 1.0 / math.sqrt(config.hidden_size)
    lstm: Dict[str, Any] = {}
    in_dim = config.model_dim
    for layer in range(config.num_layers):
        for d in ("", "_reverse") if config.bidirectional else ("",):
            lstm[f"l{layer}{d}"] = {
                "weight_ih": _uniform(rng, (4 * h, in_dim), bound),
                "weight_hh": _uniform(rng, (4 * h, h), bound),
                "bias_ih": _uniform(rng, (4 * h,), bound),
                "bias_hh": _uniform(rng, (4 * h,), bound),
            }
        in_dim = h * (2 if config.bidirectional else 1)
    return {"embed_tokens": {"weight": embed}, "lstm": lstm}


def laser2_from_numpy(params: Dict[str, Any], config: Any, dtype: torch.dtype = torch.float32,
                      device: Any = None) -> Any:
    """The port's LASER2 encoder holding ``params`` (torch-layout LSTM
    weights, numpy), computing in ``dtype`` on ``device`` (None: ``cuda``)."""
    from sonar_tpu_torch.models.laser2_text.model import LaserLstmEncoder

    device = resolve_device(device)
    return LaserLstmEncoder(config, _to_torch(params, dtype, "cpu"), dtype=dtype).to(device)
