"""LASER2: the legacy bidirectional-LSTM sentence encoder.

Port of ``sonar_tpu.models.laser2_text.model``: embed (320) -> 5-layer
bi-LSTM (512) -> max-pool over time with -inf at padded positions -> a
1024-d embedding. The embedding table is a parameter tree as in the port's
other models; the LSTM is an ``nn.LSTM`` over packed sequences
(``nn.lstm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
from sonar_tpu_torch.models.common import ConfigRegistry, ParamTree
from sonar_tpu_torch.nn.core import Params, embedding_lookup
from sonar_tpu_torch.nn.lstm import bilstm_stack, build_lstm
from sonar_tpu_torch.ops.precision import matmul_precision_for
import torch
from torch import nn


@dataclass
class Laser2Config:
    vocabulary_size: int
    pad_idx: int
    model_dim: int = 320
    hidden_size: int = 512
    num_layers: int = 1
    bidirectional: bool = False
    padding_value: float = 0.0


laser2_archs: ConfigRegistry[Laser2Config] = ConfigRegistry("laser2")


@laser2_archs.arch("laser2")
def _laser2() -> Laser2Config:
    return Laser2Config(vocabulary_size=50004, pad_idx=1, model_dim=320, hidden_size=512,
                        num_layers=5, bidirectional=True)


@laser2_archs.arch("toy")
def _toy() -> Laser2Config:
    return Laser2Config(vocabulary_size=128, pad_idx=1, model_dim=16, hidden_size=24,
                        num_layers=2, bidirectional=True)


class LaserLstmEncoder(nn.Module):
    """``forward(seqs [B, S], seq_lens [B])`` -> [B, output_units]
    embeddings in ``dtype`` (fp32 by default, with true fp32 products)."""

    def __init__(self, config: Laser2Config, params: Params, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.output_units = config.hidden_size * (2 if config.bidirectional else 1)
        self.params = ParamTree({"embed_tokens": dict(params["embed_tokens"])})
        self.lstm = build_lstm(params["lstm"], config.model_dim, config.hidden_size,
                               config.num_layers, config.bidirectional).to(dtype)

    @property
    def device(self) -> torch.device:
        return self.params.embed_tokens.weight.device

    def forward(self, seqs: Any, seq_lens: Any) -> torch.Tensor:
        dev = self.device
        seqs = torch.as_tensor(np.asarray(seqs) if not torch.is_tensor(seqs) else seqs).to(dev)
        lens = torch.as_tensor(np.asarray(seq_lens) if not torch.is_tensor(seq_lens)
                               else seq_lens).to(dev)
        with torch.inference_mode(), matmul_precision_for(self.dtype):
            x = embedding_lookup(self.params.tree()["embed_tokens"], seqs, dtype=self.dtype)
            x = x.transpose(0, 1)                                         # [T, B, C]
            outs = bilstm_stack(self.lstm, x, lens, self.config.padding_value)
            valid = (torch.arange(outs.shape[0], device=dev)[:, None] < lens[None, :])[..., None]
            return torch.where(valid, outs, -torch.inf).amax(dim=0)


def laser2_params_from_torch(flat: dict) -> Params:
    """torch ``LaserLstmEncoder`` state dict -> the parameter tree (the same
    key names, numpy arrays)."""
    params: Params = {"embed_tokens": {"weight": np.asarray(flat["embed_tokens.weight"])},
                      "lstm": {}}
    layer = 0
    while f"lstm.weight_ih_l{layer}" in flat:
        for d in ("", "_reverse"):
            if f"lstm.weight_ih_l{layer}{d}" not in flat:
                continue
            params["lstm"][f"l{layer}{d}"] = {
                name: np.asarray(flat[f"lstm.{name}_l{layer}{d}"])
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
            }
        layer += 1
    return params
