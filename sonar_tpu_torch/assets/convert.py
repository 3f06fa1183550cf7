"""Weights for the port's text encoder.

All routes produce the JAX package's parameter layout (linear kernels
[in, out], per-layer tensors stacked on a leading L axis) as numpy arrays,
then load it into ``SonarTextEncoder``:

- ``text_encoder_from_numpy``: the JAX package's pytree (from
  ``SonarTextEncoder.init_params`` or ``checkpoint.text_encoder_params``,
  as numpy) -> the port's module computing the same function;
- ``init_text_encoder_params``: a seeded numpy-only initialiser with the JAX
  package's distributions (for runs where JAX is absent);
- ``text_encoder_params_from_state`` / ``load_text_encoder_checkpoint``: a
  fairseq2 or fairseq1 state dict -> the pytree, without JAX (layers are
  stacked with numpy).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
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


def init_text_encoder_params(config: SonarTextEncoderConfig, seed: int = 0) -> Dict[str, Any]:
    """Seeded random pytree of ``config``'s shape, drawn with numpy.

    Same distributions as the JAX ``init_params`` (Kaiming-uniform fan-in
    linears, N(0, d^-0.5) embedding with a zero pad row, unit LayerNorms),
    not the same numbers.
    """
    rng = np.random.default_rng(seed)
    d, f, n = config.model_dim, config.ffn_inner_dim, config.num_encoder_layers

    def linear(in_dim: int, out_dim: int) -> Dict[str, np.ndarray]:
        bound = math.sqrt(1.0 / in_dim)
        kernel = np.empty((n, in_dim, out_dim), np.float32)
        bias = np.empty((n, out_dim), np.float32)
        for i in range(n):  # one layer at a time bounds the temporaries
            kernel[i] = _uniform(rng, (in_dim, out_dim), math.sqrt(3.0) * bound)
            bias[i] = _uniform(rng, (out_dim,), bound)
        return {"kernel": kernel, "bias": bias}

    def ln(shape: tuple) -> Dict[str, np.ndarray]:
        return {"weight": np.ones(shape, np.float32), "bias": np.zeros(shape, np.float32)}

    embed = rng.standard_normal((config.vocab_info.size, d), dtype=np.float32)
    embed *= np.float32(d ** -0.5)
    if config.vocab_info.pad_idx is not None:
        embed[config.vocab_info.pad_idx] = 0.0
    layers = {
        "self_attn": {p: linear(d, d) for p in ("q_proj", "k_proj", "v_proj", "output_proj")},
        "self_attn_layer_norm": ln((n, d)),
        "ffn": {"inner_proj": linear(d, f), "output_proj": linear(f, d)},
        "ffn_layer_norm": ln((n, d)),
    }
    params: Dict[str, Any] = {
        "encoder_frontend": {"embed": {"weight": embed}},
        "encoder": {"layers": layers},
        "layer_norm": ln((d,)),
    }
    if config.normalize_before:
        params["encoder"]["layer_norm"] = ln((d,))
    return params


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
    if "pooler.projection_out.weight" in flat:
        raise NotImplementedError("the ATTENTION pooler is not ported yet")
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
    return params


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
