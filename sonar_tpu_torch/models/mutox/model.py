"""MuTox: a toxicity classifier over SONAR embeddings.

Port of ``sonar_tpu.models.mutox.model``: 1024 -> 512 -> ReLU -> 128 ->
ReLU -> 1 (dropout 0.01 is inert at inference); ``output_prob=True``
applies a sigmoid. fp32 with true fp32 products, on the device its
parameters are on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
from sonar_tpu_torch.models.blaser.model import as_float_input
from sonar_tpu_torch.models.common import ConfigRegistry, ParamTree
from sonar_tpu_torch.nn.core import Params, linear
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch
from torch import nn


@dataclass
class MutoxConfig:
    input_size: int = 1024


mutox_archs: ConfigRegistry[MutoxConfig] = ConfigRegistry("mutox")


@mutox_archs.arch("mutox")
def _mutox() -> MutoxConfig:
    return MutoxConfig(input_size=1024)


class MutoxClassifier(nn.Module):
    """``forward(inputs [N, input_size], output_prob=False)`` -> [N, 1] fp32;
    ``forward_with`` runs the same function on an explicit parameter tree
    and tensor (the counterpart of the JAX model's ``apply``; training)."""

    HIDDEN = (512, 128)

    def __init__(self, config: MutoxConfig, params: Params):
        super().__init__()
        self.config = config
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return next(self.params.buffers()).device

    def forward(self, inputs: Any, output_prob: bool = False) -> torch.Tensor:
        x = as_float_input(inputs, self.device)
        with torch.inference_mode(), matmul_precision_for(torch.float32):
            return self.forward_with(self.params.tree(), x, output_prob)

    def forward_with(self, params: Params, x: torch.Tensor,
                     output_prob: bool = False) -> torch.Tensor:
        layers = params["layers"]
        for i in range(len(layers)):
            if i > 0:
                x = torch.relu(x)
            x = linear(layers[str(i)], x)
        return torch.sigmoid(x) if output_prob else x


def mutox_params_from_torch(flat: dict) -> Params:
    """torch nested-Sequential keys (``model_all.{g}.1.weight``) -> the
    parameter tree of numpy arrays. Each group g in (0, 1, 2) holds
    [Dropout | ReLU, Linear]; the Linear sits at sub-index 1."""
    layers = {}
    for g in range(3):
        w = np.array(flat[f"model_all.{g}.1.weight"], dtype=np.float32, copy=True)
        p = {"kernel": np.ascontiguousarray(w.T)}
        if f"model_all.{g}.1.bias" in flat:
            p["bias"] = np.asarray(flat[f"model_all.{g}.1.bias"], np.float32)
        layers[str(g)] = p
    return {"layers": layers}
