"""Position encoders (``sonar_tpu.nn.position``): fairseq-legacy
sinusoidal and learned.

Sinusoidal: table[p] = concat(sin(p * w), cos(p * w)), w_i = exp(-i * ln(10000) / (half - 1)):
the half-split layout with fairseq1's (half - 1) denominator. With a legacy
pad index, sequence position t reads table row ``t + pad_idx + 1``.
Learned: a [max_seq_len, D] parameter (``{"weight": ...}`` in the tree),
read from row 0 with no offset.

The incremental ``step`` is a host int or a 0-d integer tensor on the
device (the decoder cache's write position): a device step selects its rows
with ``index_select`` and reads nothing back to the host, so its range
cannot be checked there; like JAX's ``dynamic_slice`` it is clamped to the
table. A host step past the table raises.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

Step = Union[int, torch.Tensor]


def _rows(table: torch.Tensor, start: Step, seq_len: int, limit: int) -> torch.Tensor:
    """``table[start : start + seq_len]``; ``limit`` is the table's usable
    row count. A device ``start`` is clamped to [0, limit - seq_len]."""
    if torch.is_tensor(start):
        first = start.reshape(1).clamp(0, limit - seq_len)
        rows = first + torch.arange(seq_len, device=first.device) if seq_len > 1 else first
        return table.index_select(0, rows)
    if start + seq_len > limit:
        raise ValueError(f"positions up to {start + seq_len} exceed the {limit}-row position "
                         f"table")
    return table[start:start + seq_len]


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

    def __call__(self, seqs: torch.Tensor, step: Step = 0) -> torch.Tensor:
        """seqs: [B, S, D]; returns seqs + PE[offset + step : offset + step + S]
        (``step`` is the position of an incremental decode step)."""
        pe = _rows(self.table(seqs.device, seqs.dtype), self.offset + step, seqs.shape[1],
                   self.max_seq_len)
        return seqs + pe[None, :, :]


class LearnedPositionEncoder:
    """Learned positional embeddings (fairseq2 ``LearnedPositionEncoder``):
    the table is the parameter tree's ``{"weight": [max_seq_len, D]}``."""

    def __init__(self, dim: int, max_seq_len: int):
        self.dim = dim
        self.max_seq_len = max_seq_len

    def __call__(self, params: dict, seqs: torch.Tensor, step: Step = 0) -> torch.Tensor:
        """seqs: [B, S, D]; returns seqs + weight[step : step + S]."""
        pe = _rows(params["weight"], step, seqs.shape[1], self.max_seq_len).to(seqs.dtype)
        return seqs + pe[None, :, :]
