"""Weights for the port's text and speech encoders.

All routes produce the JAX package's parameter layout (linear kernels
[in, out], per-layer tensors stacked on a leading L axis) as numpy arrays,
then load it into ``SonarTextEncoder`` or ``SonarSpeechEncoder``:

- ``text_encoder_from_numpy`` / ``speech_encoder_from_numpy``: the JAX
  package's pytree (from ``init_params`` or the ``checkpoint`` converters,
  as numpy) -> the port's module computing the same function;
- ``init_text_encoder_params`` / ``init_speech_encoder_params``: seeded
  numpy-only initialisers with the JAX package's distributions (for runs
  where JAX is absent);
- ``text_encoder_params_from_state`` / ``load_text_encoder_checkpoint`` and
  ``speech_encoder_params_from_state`` / ``load_speech_encoder_checkpoint``:
  a fairseq2 or fairseq1 state dict -> the pytree, without JAX (the key
  maps of ``sonar_tpu.assets.checkpoint`` and ``checkpoint_speech``, layers
  stacked with numpy).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
from sonar_tpu_torch.models.sonar_speech.config import SonarSpeechEncoderConfig
from sonar_tpu_torch.models.sonar_speech.model import SonarSpeechEncoder
from sonar_tpu_torch.models.sonar_text.config import SonarTextEncoderConfig
from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder
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


def _init_pooler(rng: np.random.Generator, n: int, dim: int, kv_dim: int, ffn_dim: int,
                 embed_rows: int, pad_idx: int, proj_bias: bool,
                 final_ln: bool) -> Dict[str, Any]:
    """An ATTENTION pooler: ``n`` decoder layers, its BOS table, projection."""
    def attn(in_kv: int) -> Dict[str, Any]:
        return {"q_proj": _init_linear(rng, n, dim, dim),
                "k_proj": _init_linear(rng, n, in_kv, dim),
                "v_proj": _init_linear(rng, n, in_kv, dim),
                "output_proj": _init_linear(rng, n, dim, dim)}

    layers = {
        "self_attn": attn(dim),
        "self_attn_layer_norm": _init_ln((n, dim)),
        "encoder_decoder_attn": attn(kv_dim),
        "encoder_decoder_attn_layer_norm": _init_ln((n, dim)),
        "ffn": {"inner_proj": _init_linear(rng, n, dim, ffn_dim),
                "output_proj": _init_linear(rng, n, ffn_dim, dim)},
        "ffn_layer_norm": _init_ln((n, dim)),
    }
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


def _stack(layer_dicts: list) -> Dict[str, Any]:
    first = layer_dicts[0]
    return {
        k: _stack([ld[k] for ld in layer_dicts]) if isinstance(first[k], dict)
        else np.stack([ld[k] for ld in layer_dicts])
        for k in first
    }


def text_encoder_params_from_state(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Flat fairseq2 (or fairseq1) state dict -> the JAX-layout pytree.

    The same conversion as ``sonar_tpu.assets.checkpoint.text_encoder_params``
    (whose layer stacking goes through jax), stacked with numpy here.
    """
    from sonar_tpu.assets import checkpoint as ckpt

    flat = ckpt.convert_text_encoder_state(flat)
    layers = []
    for i in range(ckpt._num_layers(flat, "encoder.layers")):
        p = f"encoder.layers.{i}"
        layers.append({
            "self_attn": ckpt._mha(flat, f"{p}.self_attn"),
            "self_attn_layer_norm": ckpt._layer_norm(flat, f"{p}.self_attn_layer_norm"),
            "ffn": ckpt._ffn(flat, f"{p}.ffn"),
            "ffn_layer_norm": ckpt._layer_norm(flat, f"{p}.ffn_layer_norm"),
        })
    params: Dict[str, Any] = {
        "encoder_frontend": {"embed": {"weight": flat["encoder_frontend.embed.weight"]}},
        "encoder": {"layers": _stack(layers)},
        "layer_norm": ckpt._layer_norm(flat, "layer_norm"),
    }
    if "encoder.layer_norm.weight" in flat:
        params["encoder"]["layer_norm"] = ckpt._layer_norm(flat, "encoder.layer_norm")
    if "pooler.projection_out.weight" in flat:
        params["pooler"] = _pooler_from_state(flat, "pooler")
    return params


def _pooler_from_state(flat: Dict[str, np.ndarray], stem: str) -> Dict[str, Any]:
    """An ATTENTION pooler's converted state -> its pytree, as
    ``checkpoint._attention_pooler_params`` and
    ``checkpoint_speech._pooler_params`` build it (the speech one's
    ``projection_out`` has no bias)."""
    from sonar_tpu.assets import checkpoint as ckpt

    layers = []
    for i in range(ckpt._num_layers(flat, f"{stem}.decoder.layers")):
        p = f"{stem}.decoder.layers.{i}"
        layers.append({
            "self_attn": ckpt._mha(flat, f"{p}.self_attn"),
            "self_attn_layer_norm": ckpt._layer_norm(flat, f"{p}.self_attn_layer_norm"),
            "encoder_decoder_attn": ckpt._mha(flat, f"{p}.encoder_decoder_attn"),
            "encoder_decoder_attn_layer_norm": ckpt._layer_norm(
                flat, f"{p}.encoder_decoder_attn_layer_norm"),
            "ffn": ckpt._ffn(flat, f"{p}.ffn"),
            "ffn_layer_norm": ckpt._layer_norm(flat, f"{p}.ffn_layer_norm"),
        })
    pooler: Dict[str, Any] = {
        "decoder_frontend": {"embed": {"weight": flat[f"{stem}.decoder_frontend.embed.weight"]}},
        "decoder": {"layers": _stack(layers)},
        "projection_out": ckpt._linear(flat, f"{stem}.projection_out"),
    }
    if f"{stem}.decoder.layer_norm.weight" in flat:
        pooler["decoder"]["layer_norm"] = ckpt._layer_norm(flat, f"{stem}.decoder.layer_norm")
    return pooler


def load_text_encoder_checkpoint(
    path: Union[str, Path],
    config: SonarTextEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarTextEncoder:
    """A ``.pt`` text-encoder checkpoint -> the port's encoder, its
    floating-point parameters stored in ``dtype``."""
    from sonar_tpu.assets.checkpoint import load_torch_state_dict

    params = text_encoder_params_from_state(load_torch_state_dict(path))
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
    JAX-layout pytree: ``checkpoint_speech.speech_encoder_params`` (whose
    layer stacking goes through jax), stacked with numpy here."""
    from sonar_tpu.assets import checkpoint as ckpt
    from sonar_tpu.assets import checkpoint_speech as cks

    flat = cks.convert_speech_state(flat)
    layers = []
    for i in range(ckpt._num_layers(flat, "encoder.layers")):
        p = f"encoder.layers.{i}"
        layers.append({
            "ffn1_layer_norm": ckpt._layer_norm(flat, f"{p}.ffn1_layer_norm"),
            "ffn1": ckpt._ffn(flat, f"{p}.ffn1"),
            "self_attn_layer_norm": ckpt._layer_norm(flat, f"{p}.self_attn_layer_norm"),
            "self_attn": {
                **ckpt._mha(flat, f"{p}.self_attn"),
                "sdpa": {
                    "r_proj": ckpt._linear(flat, f"{p}.self_attn.sdpa.r_proj"),
                    "u_bias": flat[f"{p}.self_attn.sdpa.u_bias"],
                    "v_bias": flat[f"{p}.self_attn.sdpa.v_bias"],
                },
            },
            "conv_layer_norm": ckpt._layer_norm(flat, f"{p}.conv_layer_norm"),
            "conv": cks._conv_module(flat, f"{p}.conv"),
            "ffn2_layer_norm": ckpt._layer_norm(flat, f"{p}.ffn2_layer_norm"),
            "ffn2": ckpt._ffn(flat, f"{p}.ffn2"),
            "layer_norm": ckpt._layer_norm(flat, f"{p}.layer_norm"),
        })
    return {
        "encoder_frontend": {
            "post_extract_layer_norm": ckpt._layer_norm(
                flat, "encoder_frontend.post_extract_layer_norm"),
            "model_dim_proj": ckpt._linear(flat, "encoder_frontend.model_dim_proj"),
        },
        "encoder": {"layers": _stack(layers)},
        "layer_norm": ckpt._layer_norm(flat, "layer_norm"),
        "encoder_pooler": _pooler_from_state(flat, "encoder_pooler"),
    }


def load_speech_encoder_checkpoint(
    path: Union[str, Path],
    config: SonarSpeechEncoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Any = "cpu",
) -> SonarSpeechEncoder:
    """A ``.pt`` speech-encoder checkpoint -> the port's encoder, its
    floating-point parameters stored in ``dtype``."""
    from sonar_tpu.assets.checkpoint import load_torch_state_dict

    params = speech_encoder_params_from_state(load_torch_state_dict(path))
    return speech_encoder_from_numpy(params, config, dtype, device)
