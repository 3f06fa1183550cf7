"""Sequence pooling to sentence embeddings (``sonar_tpu.nn.pooling``).

MEAN keeps the reference's ``1 / (len + 1e-7)`` epsilon. ``attention_pool``
is the encoders' ATTENTION pooler (``AttentionEncoderOutputPooler``): a
small Transformer decoder attends from one BOS embedding to the encoded
sequence, then an output projection.
"""

from __future__ import annotations

import enum
from typing import Any, Optional

from sonar_tpu_torch.nn.core import Params, layer_norm, linear
from sonar_tpu_torch.nn.transformer import decoder_stack
from sonar_tpu_torch.ops.masks import additive_bias, length_mask
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


def attention_pool(
    pooler: Params,
    frontend: Any,
    encoded: torch.Tensor,
    seq_lens: Optional[torch.Tensor],
    bos_idx: int,
    num_heads: int,
    activation: str,
    norm_order: str,
) -> torch.Tensor:
    """[B, S, D] -> [B, D]: the decoder stack of ``pooler`` runs on the
    embedding of token ``bos_idx`` (``frontend``) against ``encoded``, keys
    past ``seq_lens`` masked; then ``projection_out``."""
    b, s, _ = encoded.shape
    memory_bias = None
    if seq_lens is not None:
        memory_bias = additive_bias(length_mask(seq_lens, s))[:, None, None, :]
    bos = torch.full((b, 1), bos_idx, dtype=torch.int32, device=encoded.device)
    x = frontend(pooler["decoder_frontend"], bos, dtype=encoded.dtype)
    x = decoder_stack(pooler["decoder"]["layers"], x, None, encoded, memory_bias, num_heads,
                      activation, norm_order=norm_order)
    if "layer_norm" in pooler["decoder"]:
        x = layer_norm(pooler["decoder"]["layer_norm"], x)
    return linear(pooler["projection_out"], x)[:, 0]
