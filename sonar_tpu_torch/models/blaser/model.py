"""BLASER 2.0: an MLP regressor over SONAR embedding features.

Port of ``sonar_tpu.models.blaser.model``:

- feature layouts: COMET (reference-based) = [ref, mt, src*mt, ref*mt,
  |mt-src|, |mt-ref|] (6 x dim); QE = [src, mt, src*mt, |mt-src|] (4 x dim),
- optional L2 normalization of each input embedding,
- MLP: Linear(in, 3072) -> Tanh -> Linear(3072, 1536) -> Tanh ->
  Linear(1536, 1) (dropout is inert at inference), optional Tanh output.

The parameters (``{"mlp": {"0": linear, ...}}``, kernels [in, out]) are an
``nn.Module`` tree as in the port's other models; the head runs in fp32
with true fp32 products on the device its parameters are on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
from sonar_tpu_torch.models.common import ConfigRegistry, ParamTree
from sonar_tpu_torch.nn.core import Params, get_activation, linear
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch
from torch import nn

BLASER_INPUT_FORMS = {"COMET", "QE"}


@dataclass
class BlaserConfig:
    input_form: str = "COMET"
    norm_emb: bool = True
    embedding_dim: int = 1024
    output_dim: int = 1
    hidden_dims: List[int] = field(default_factory=lambda: [3072, 1536])
    dropout: float = 0.1
    activation: str = "TANH"
    output_act: bool = False

    def __post_init__(self):
        if self.input_form not in BLASER_INPUT_FORMS:
            raise ValueError(f"Input form '{self.input_form}' is invalid")
        if self.activation.lower() not in ("tanh", "relu"):
            raise ValueError(f"Activation '{self.activation}' is invalid")

    @property
    def feature_dim(self) -> int:
        return self.embedding_dim * (6 if self.input_form == "COMET" else 4)


blaser_archs: ConfigRegistry[BlaserConfig] = ConfigRegistry("blaser")


@blaser_archs.arch("basic_ref")
def _basic_ref() -> BlaserConfig:
    return BlaserConfig(input_form="COMET")


@blaser_archs.arch("basic_qe")
def _basic_qe() -> BlaserConfig:
    return BlaserConfig(input_form="QE")


def as_float_input(x: Any, device: torch.device) -> torch.Tensor:
    """An array-like (numpy, list or tensor) as an fp32 tensor on ``device``."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=torch.float32)


class BlaserModel(nn.Module):
    """``forward(src, mt, ref=None)`` -> [N, output_dim] fp32 scores;
    ``forward_with`` runs the same function on an explicit parameter tree
    and tensors (the counterpart of the JAX model's ``apply``; training)."""

    def __init__(self, config: BlaserConfig, params: Params):
        super().__init__()
        self.config = config
        self.params = ParamTree(params)

    @property
    def device(self) -> torch.device:
        return next(self.params.buffers()).device

    def featurize(self, src: torch.Tensor, mt: torch.Tensor,
                  ref: Optional[torch.Tensor]) -> torch.Tensor:
        if self.config.input_form == "COMET":
            if ref is None:
                raise ValueError(
                    "With the COMET input form of BLASER, a reference embedding must be provided."
                )
            return torch.cat([ref, mt, src * mt, ref * mt, (mt - src).abs(), (mt - ref).abs()],
                             dim=-1)
        return torch.cat([src, mt, src * mt, (mt - src).abs()], dim=-1)

    def forward(self, src: Any, mt: Any, ref: Any = None) -> torch.Tensor:
        dev = self.device
        src, mt = as_float_input(src, dev), as_float_input(mt, dev)
        ref = None if ref is None else as_float_input(ref, dev)
        with torch.inference_mode(), matmul_precision_for(torch.float32):
            return self.forward_with(self.params.tree(), src, mt, ref)

    def forward_with(self, params: Params, src: torch.Tensor, mt: torch.Tensor,
                     ref: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        mlp = params["mlp"]
        if cfg.norm_emb:
            def norm(e):
                return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-12)

            src, mt = norm(src), norm(mt)
            ref = None if ref is None else norm(ref)
        x = self.featurize(src, mt, ref)
        act = get_activation(cfg.activation)
        for i in range(len(mlp)):
            x = linear(mlp[str(i)], x)
            if i < len(mlp) - 1:
                x = act(x)
        return torch.tanh(x) if cfg.output_act else x


def blaser_params_from_torch(flat: dict) -> Params:
    """torch Sequential state (``mlp.{i}.weight``) -> the parameter tree of
    numpy arrays. The Sequential's indices include its Dropout and Tanh
    modules; the Linear layers are the keys that carry weights, renumbered
    densely in order."""
    import re

    idxs = sorted({int(m.group(1)) for k in flat
                   if (m := re.match(r"^mlp\.(\d+)\.weight$", k))})
    mlp = {}
    for new_i, i in enumerate(idxs):
        w = np.array(flat[f"mlp.{i}.weight"], dtype=np.float32, copy=True)
        p = {"kernel": np.ascontiguousarray(w.T)}
        if f"mlp.{i}.bias" in flat:
            p["bias"] = np.asarray(flat[f"mlp.{i}.bias"], np.float32)
        mlp[str(new_i)] = p
    return {"mlp": mlp}
