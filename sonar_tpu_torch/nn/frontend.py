"""Transformer embedding frontend (``sonar_tpu.nn.frontend``), inference only.

Scaled token embedding (x sqrt(d) unless ``no_scale``) -> sinusoidal
positional encoding -> optional LayerNorm.
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.nn.core import Params, embedding_lookup, layer_norm
from sonar_tpu_torch.nn.position import SinusoidalPositionEncoder
import torch


class EmbeddingFrontend:
    """Static parts of the frontend; parameters live in the tree:

    params = {"embed": {"weight": [V, D]}, "layer_norm": {...}?}
    """

    def __init__(
        self,
        model_dim: int,
        max_seq_len: int,
        no_scale: bool = False,
        layernorm: bool = False,
        legacy_pad_idx: Optional[int] = None,
        no_pos: bool = False,
    ):
        self.model_dim = model_dim
        self.max_seq_len = max_seq_len
        self.scale = 1.0 if no_scale else float(model_dim) ** 0.5
        self.layernorm = layernorm
        self.pos_encoder = None if no_pos else SinusoidalPositionEncoder(
            model_dim, max_seq_len, legacy_pad_idx=legacy_pad_idx
        )

    def __call__(
        self, params: Params, seqs: torch.Tensor, dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """seqs: [B, S] int token ids -> [B, S, D] embeddings."""
        x = embedding_lookup(params["embed"], seqs, dtype=dtype)
        if self.scale != 1.0:
            # Scale in the compute dtype, as the reference multiplies by a
            # dtype-typed scalar.
            x = x * torch.tensor(self.scale, dtype=dtype)
        if self.pos_encoder is not None:
            x = self.pos_encoder(x)
        if self.layernorm:
            x = layer_norm(params["layer_norm"], x)
        return x
