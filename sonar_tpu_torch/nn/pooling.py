"""Sequence pooling to sentence embeddings (``sonar_tpu.nn.pooling``).

MEAN keeps the reference's ``1 / (len + 1e-7)`` epsilon.
"""

from __future__ import annotations

import enum
from typing import Optional

from sonar_tpu_torch.ops.masks import length_mask
import torch


class Pooling(enum.Enum):
    MAX = "max"
    MEAN = "mean"
    LAST = "last"
    ATTENTION = "attention"


def static_pool(
    seqs: torch.Tensor,
    seq_lens: Optional[torch.Tensor],
    pooling: Pooling,
) -> torch.Tensor:
    """[B, S, D] -> [B, D]. ``seq_lens=None`` means all positions are valid."""
    b, s, _ = seqs.shape
    mask = None if seq_lens is None else length_mask(seq_lens, s)

    if pooling == Pooling.LAST:
        if seq_lens is None:
            return seqs[:, -1]
        idx = torch.clamp(seq_lens.long() - 1, 0, s - 1)
        return seqs[torch.arange(b, device=seqs.device), idx]

    if pooling == Pooling.MAX:
        if mask is not None:
            seqs = seqs.masked_fill(~mask[..., None], float("-inf"))
        return seqs.amax(dim=1)

    if pooling == Pooling.MEAN:
        if mask is not None:
            seqs = seqs.masked_fill(~mask[..., None], 0.0)
        total = seqs.sum(dim=1)
        if seq_lens is None:
            denom = torch.full((b,), float(s), dtype=total.dtype, device=total.device)
        else:
            denom = seq_lens.to(total.dtype)
        return total * (1.0 / (denom + 1e-7))[:, None]

    raise NotImplementedError(f"static pooling does not support {pooling}")
