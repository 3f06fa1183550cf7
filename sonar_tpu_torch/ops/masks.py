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


def mask_from_lengths(seq_lens: Optional[torch.Tensor], max_len: int) -> Optional[torch.Tensor]:
    if seq_lens is None:
        return None
    return length_mask(seq_lens, max_len)


def apply_padding_mask(
    seqs: torch.Tensor, mask: Optional[torch.Tensor], pad_value: float = 0.0
) -> torch.Tensor:
    """Zero (or fill) padded positions of [B, S, D] given a [B, S] bool mask."""
    if mask is None:
        return seqs
    fill = torch.full((), pad_value, dtype=seqs.dtype, device=seqs.device)
    return torch.where(mask[..., None], seqs, fill)


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Logical AND of broadcastable boolean masks; None entries are skipped."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else torch.logical_and(out, m)
    return out


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
