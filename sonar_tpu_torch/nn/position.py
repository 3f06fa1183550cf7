"""Fairseq-legacy sinusoidal position encoder (``sonar_tpu.nn.position``).

table[p] = concat(sin(p * w), cos(p * w)), w_i = exp(-i * ln(10000) / (half - 1)):
the half-split layout with fairseq1's (half - 1) denominator. With a legacy
pad index, sequence position t reads table row ``t + pad_idx + 1``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def sinusoidal_table(max_len: int, dim: int) -> torch.Tensor:
    """[max_len, dim] fp32 table, computed in float64 and rounded once."""
    half = dim // 2
    if half > 1:
        inv_freq = np.exp(
            np.arange(half, dtype=np.float64) * (-math.log(10000.0) / (half - 1))
        )
    else:
        inv_freq = np.ones((half,), np.float64)
    args = np.arange(max_len, dtype=np.float64)[:, None] * inv_freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((max_len, 1))], axis=1)
    return torch.from_numpy(table.astype(np.float32))


class SinusoidalPositionEncoder:
    """Stateless sinusoidal PE with the optional fairseq legacy pad offset.

    ``max_seq_len`` is the table row count (already including the
    ``pad_idx + 1`` headroom of legacy configs).
    """

    def __init__(self, dim: int, max_seq_len: int, legacy_pad_idx: Optional[int] = None):
        self.dim = dim
        self.max_seq_len = max_seq_len
        self.offset = 0 if legacy_pad_idx is None else legacy_pad_idx + 1
        self._table = sinusoidal_table(max_seq_len, dim)
        self._cache: dict = {}

    def table(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        key = (str(device), dtype)
        if key not in self._cache:
            self._cache[key] = self._table.to(device=device, dtype=dtype)
        return self._cache[key]

    def __call__(self, seqs: torch.Tensor) -> torch.Tensor:
        """seqs: [B, S, D]; returns seqs + PE[offset : offset + S]."""
        seq_len = seqs.shape[1]
        pe = self.table(seqs.device, seqs.dtype)[self.offset:self.offset + seq_len]
        return seqs + pe[None, :, :]
