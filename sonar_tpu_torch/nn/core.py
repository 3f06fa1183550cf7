"""Functional NN primitives over nested-dict parameter trees.

Counterpart of ``sonar_tpu.nn.core``. Parameters keep the JAX package's
layout so converted weights map one-to-one:

- Linear: ``{"kernel": [in, out], "bias": [out]}``, or after int8
  quantization ``{"kernel_q": int8 [in, out], "scale": fp32 [1, out],
  "bias": [out]}``;
- LayerNorm: ``{"weight": [d], "bias": [d]}``;
- Embedding: ``{"weight": [V, d]}``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

Params = Dict[str, Any]


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "kernel_q" in params:
        from sonar_tpu_torch.ops.quantization import int8_linear

        return int8_linear(params, x)
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["weight"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_lookup(
    params: Params, ids: torch.Tensor, dtype: Optional[torch.dtype] = None
) -> torch.Tensor:
    # Gather first, cast after: the same values as casting the whole table,
    # without converting all V rows on every call.
    out = params["weight"][ids.long()]
    return out if dtype is None else out.to(dtype)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {"relu": torch.relu}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The FFN activation; the SONAR text encoders use ReLU only."""
    key = name.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unsupported activation: {name}")
    return ACTIVATIONS[key]
