"""Padding / attention mask utilities (``sonar_tpu.ops.masks``).

Batches are right-padded; ``seq_lens`` (int32 [B]) is the canonical padding
representation and boolean masks (True = valid) are derived from it.
"""

from __future__ import annotations

from typing import Optional

import torch


def length_mask(seq_lens: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] int lengths -> [B, max_len] bool mask (True = valid)."""
    positions = torch.arange(max_len, dtype=torch.int32, device=seq_lens.device)
    return positions[None, :] < seq_lens[:, None]


def additive_bias(
    mask: Optional[torch.Tensor], dtype: torch.dtype = torch.float32
) -> Optional[torch.Tensor]:
    """Bool mask -> additive attention bias (0 where valid, ``finfo.min`` else).

    ``finfo.min`` and not ``-inf``: a fully masked row (a padding row of
    length 0) then gets a uniform softmax instead of NaN; its output is
    discarded downstream.
    """
    if mask is None:
        return None
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), torch.finfo(dtype).min, dtype=dtype, device=mask.device)
    return torch.where(mask, zero, neg)
