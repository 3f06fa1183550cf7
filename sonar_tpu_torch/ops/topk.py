"""Exact top-k over very wide trailing axes (``sonar_tpu.ops.topk``).

``top_k`` is ``lax.top_k``'s contract in PyTorch: the k largest values,
ties broken by the lower index first (a stable descending sort;
``torch.topk`` promises no tie order). Over an NLLB-size row (256k
columns) a full sort is almost all wasted work at beam-search k, so
``exact_top_k_wide`` narrows the row first, exactly:

1. reduce the row to per-block maxima,
2. pick the top-k blocks by (max desc, block index asc),
3. gather those k blocks in ascending block order and take the top k of
   the k * block_size candidates.

An element outside the chosen blocks is beaten by k block maxima (a larger
value, or an equal one at a lower index), so it is not in the top k; the
gathered row keeps the global index order, so ties resolve as in the full
row.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values and int64 indices, ties to
    the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def exact_top_k_wide(x: torch.Tensor, k: int,
                     block_size: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """``top_k(x, k)`` over the last axis through block maxima; the same
    values, indices and tie order for finite input."""
    width = x.shape[-1]
    if k > width:
        raise ValueError(f"k={k} > trailing width {width}")
    nb = -(-width // block_size)
    if width <= 2 * block_size or nb < k:
        return top_k(x, k)
    pad = nb * block_size - width
    if pad:
        x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    blocked = x.reshape(*x.shape[:-1], nb, block_size)
    _, bidx = top_k(blocked.amax(dim=-1), k)                       # [..., k]
    bidx, _ = torch.sort(bidx, dim=-1)
    cand = torch.gather(blocked, -2, bidx[..., None].expand(*bidx.shape, block_size))
    cols = bidx[..., None] * block_size + torch.arange(block_size, device=x.device)
    vals, pos = top_k(cand.reshape(*cand.shape[:-2], k * block_size), k)
    idx = torch.gather(cols.reshape(*cols.shape[:-2], k * block_size), -1, pos)
    if pad:
        idx = torch.clamp(idx, max=width - 1)
    return vals, idx
