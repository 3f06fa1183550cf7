"""Cosine-similarity mining and the xsim / xsim++ evaluation.

Port of ``sonar_tpu/parallel/mining.py``, with the same names and
signatures (and a ``device`` argument):

- ``cosine_topk``: each query's k nearest bank rows by cosine, the bank
  taken in ``block_size``-row blocks with a running [N, k] merge, so the
  [N, M] similarity matrix never exists (65,536 x 65,536 would be 17 GB in
  fp32). The product is fp32 (true fp32: no TF32), bf16 with fp32 output,
  or int8 with int32 accumulation over per-row quantised banks;
- ``xsim`` and ``xsim_pp``: the LASER xsim error rate (%) of margin-based
  nearest-neighbour alignment, dense, and with distractor targets;
- ``mine_bitexts``: LASER-style margin mining (forward, backward,
  intersection, union) from both directions' top-k lists;
- ``sharded_cosine_topk``, ``sharded_xsim``, ``sharded_xsim_pp`` and
  ``mine_bitexts(mesh=...)``: the bank split over one axis of a
  ``parallel.mesh.Mesh``; each rank takes the top k of its block and the
  candidates of every block are merged in block order.

The products and the selection are PyTorch calls, as the JAX package leaves
them to XLA: no Pallas kernel is on this path. Inputs are numpy arrays or
tensors. Like every entry point of the port these run on the GPU (``cuda``)
unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
from sonar_tpu_torch.device import resolve_device
from sonar_tpu_torch.ops.precision import matmul_f32_out, matmul_precision_for
from sonar_tpu_torch.ops.quantization import int8_matmul
from sonar_tpu_torch.parallel.comm import gather_blocks
import torch

_SELECT_KEYS = 1 << 26  # int64 selection keys made at a time (512 MB)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x over its row norm, clamped below at ``eps``. The norm is summed in
    float64 and rounded to x's dtype once, so the CPU and the card give the
    same bits (the int8 codes of ``cosine_topk`` depend on them); the JAX
    package sums in fp32 and may differ from it in the last bit."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True, dtype=torch.float64).to(x.dtype)
    return x / torch.clamp(norm, min=eps)


def _quant_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8: [N, D] fp32 -> (int8 [N, D], fp32 [N, 1]);
    the JAX package's operations in its order (``round`` is half to even).
    127 is a tensor on x's device: PyTorch divides a CUDA tensor by a Python
    number through its rounded reciprocal, a true division by a tensor."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / absmax.new_tensor(127.0), min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _as_f32(x: Any, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _dot_kind(dot_dtype: Any) -> Optional[Any]:
    """None (fp32), "int8", or the floating torch dtype of the product."""
    if dot_dtype is None:
        return None
    if dot_dtype in ("int8", torch.int8):
        return "int8"
    if not (isinstance(dot_dtype, torch.dtype) and dot_dtype.is_floating_point):
        raise ValueError(f"dot_dtype must be None, 'int8' or a floating dtype, got {dot_dtype!r}")
    return dot_dtype


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose high halves order fp32 values as ``lax.top_k``
    does (a total order: -0.0 below +0.0), their low halves zero."""
    bits = x.view(torch.int32)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64) << 32


def _top_k_exact(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over each row of ``x`` without sorting the row: each
    value's order key and its reversed column pack into one int64 key, so
    the keys are distinct and ties go to the lower index."""
    cols = x.shape[-1]
    rev = (cols - 1) - torch.arange(cols, device=x.device, dtype=torch.int64)
    rows = max(1, _SELECT_KEYS // cols)
    vals, idx = [], []
    for r0 in range(0, x.shape[0], rows):
        part = x[r0:r0 + rows]
        i = (cols - 1) - (torch.topk(_order_key(part) | rev, k, dim=-1).values & 0xFFFFFFFF)
        vals.append(torch.gather(part, 1, i))
        idx.append(i)
    return torch.cat(vals), torch.cat(idx)


def _block_top_k(sim: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_top_k_exact`` of a block's scores through ``torch.topk`` on the
    floats, which keeps no tie order: the k + 1 largest, whose first k are
    put in ``lax.top_k``'s order (ties to the lower index). A row whose
    (k + 1)-th value equals its k-th (so which of them is in is up to
    ``torch.topk``) is selected again by ``_top_k_exact``."""
    extra = int(k < sim.shape[-1])
    vals, idx = torch.topk(sim, k + extra, dim=-1)
    tied = (vals[:, k - 1] == vals[:, -1]).nonzero()[:, 0] if extra else None
    vals, idx = vals[:, :k], idx[:, :k]
    pos = torch.topk(_order_key(vals) | (0xFFFFFFFF - idx), k, dim=-1).indices
    vals, idx = torch.gather(vals, 1, pos), torch.gather(idx, 1, pos)
    if extra and len(tied):
        vals[tied], idx[tied] = _top_k_exact(sim[tied], k)
    return vals, idx


def cosine_topk(
    queries: Any,
    bank: Any,
    k: int,
    block_size: int = 8192,
    dot_dtype: Any = None,
    approx: bool = False,
    device: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device top-k cosine: -> (scores [N, k] fp32, indices [N, k]
    int64), tensors on ``device``.

    The bank is taken in ``block_size``-row blocks, the last one padded with
    zero rows whose scores are -inf; each block's top k merges with the
    running [N, k] list, earlier blocks' candidates first, so the result and
    its tie order (the lower bank index first) are the full row's
    ``lax.top_k``.

    ``dot_dtype``: None multiplies in fp32 (without TF32); a floating dtype
    (``torch.bfloat16``) casts both unit banks to it and keeps the product's
    fp32 sums; ``"int8"`` quantises both per row (127 levels over each row's
    absmax) and multiplies in int8 with int32 sums, rescaled by the two
    rows' scales. ``approx=True`` selects exactly: the JAX package's
    ``lax.approx_max_k`` is approximate only on a TPU and exact elsewhere,
    and the port computes that function.
    """
    del approx  # exact for both values (see the docstring)
    dev = resolve_device(device)
    q = l2_normalize(_as_f32(queries, dev))
    b = l2_normalize(_as_f32(bank, dev))
    kind = _dot_kind(dot_dtype)
    if kind == "int8":
        q, q_scale = _quant_rows_int8(q)
        b, b_scale = _quant_rows_int8(b)
    elif kind is not None:
        q, b = q.to(kind), b.to(kind)
    n, m = q.shape[0], b.shape[0]
    block = min(block_size, m)
    nblocks = -(-m // block)
    kb = min(k, block)
    best_s = torch.full((n, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((n, k), dtype=torch.int64, device=dev)
    with matmul_precision_for(torch.float32):
        for j in range(nblocks):
            base = j * block
            blk = b[base:base + block]
            if kind == "int8":
                sim = (int8_matmul(q, blk.t()).float() * q_scale
                       * b_scale[base:base + block, 0][None, :])
            elif kind is None:
                sim = q @ blk.t()
            else:
                sim = matmul_f32_out(q, blk.t())
            if blk.shape[0] < block:  # the zero-padded tail's columns score -inf
                sim = torch.nn.functional.pad(sim, (0, block - blk.shape[0]),
                                              value=float("-inf"))
            s, i = _block_top_k(sim, kb)
            best_s, pos = _top_k_exact(torch.cat([best_s, s], dim=1), k)
            best_i = torch.gather(torch.cat([best_i, base + i], dim=1), 1, pos)
    return best_s, best_i


def sharded_cosine_topk(
    queries: Any,
    bank: Any,
    k: int,
    mesh: Any,
    axis: str = "data",
    dot_dtype: Any = None,
    approx: bool = False,
    device: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``cosine_topk`` with the bank split over the mesh axis ``axis``: the
    same (scores, indices) on every rank. Every rank takes the whole bank
    and the queries.

    The bank is zero-padded to ceil(M / n) * n rows and rank i takes block
    i. Each rank's top k come from ``cosine_topk`` on its block (with
    ``dot_dtype`` and ``approx`` as there); a padded row's score is set to
    -inf by its global index; the [N, k] lists of every block are gathered
    in block order and merged by ``_top_k_exact``, so a tie goes to the
    lower block, then the lower index: the JAX package's ``lax.top_k`` over
    the concatenated candidates. The gather moves N * k * n scores.
    """
    dev = resolve_device(device)
    group = mesh.group(axis)
    b = _as_f32(bank, dev)
    m = b.shape[0]
    shard = -(-m // group.size)
    if shard * group.size != m:
        b = torch.cat([b, b.new_zeros((shard * group.size - m, b.shape[1]))])
    base = group.index * shard
    scores, idx = cosine_topk(queries, b[base:base + shard], k, dot_dtype=dot_dtype,
                              approx=approx, device=dev)
    idx = idx + base
    scores = torch.where(idx < m, scores, float("-inf"))
    cand_s = gather_blocks(scores, group, dim=1)                 # [N, n * k]
    cand_i = gather_blocks(idx, group, dim=1)
    top_s, pos = _top_k_exact(cand_s, k)
    return top_s, torch.gather(cand_i, 1, pos)


def _margin_scores(sim: torch.Tensor, avg_x: torch.Tensor, avg_y: torch.Tensor,
                   margin: str) -> torch.Tensor:
    """Dense [N, M] LASER margins (bank average broadcast over columns)."""
    if margin == "ratio":
        return sim / ((avg_x[:, None] + avg_y[None, :]) / 2.0)
    if margin == "distance":
        return sim - (avg_x[:, None] + avg_y[None, :]) / 2.0
    if margin == "absolute":
        return sim
    raise ValueError(f"unknown margin: {margin}")


def _candidate_margins(scores: np.ndarray, idx: np.ndarray, avg_q: np.ndarray,
                       avg_b: np.ndarray, margin: str) -> np.ndarray:
    """LASER margins of each query's top-k candidates ([N, k] numpy): the
    definitions of ``_margin_scores`` with the bank average gathered per
    candidate."""
    if margin == "ratio":
        return scores / ((avg_q[:, None] + avg_b[idx]) / 2.0)
    if margin == "distance":
        return scores - (avg_q[:, None] + avg_b[idx]) / 2.0
    if margin == "absolute":
        return scores
    raise ValueError(f"unknown margin: {margin}")


def _dense_xsim_pred(x: torch.Tensor, y: torch.Tensor, k: int, margin: str) -> torch.Tensor:
    """Dense-margin argmax predictions [N] (the first maximum on ties)."""
    xn, yn = l2_normalize(x), l2_normalize(y)
    with matmul_precision_for(torch.float32):
        sim = xn @ yn.t()                                  # [N, M]
    # k clamped to both axes: each direction's top k needs k <= its width.
    kk = min(k, sim.shape[0], sim.shape[1])
    avg_x = torch.topk(sim, kk, dim=1).values.mean(dim=1)  # x -> y neighbourhood
    avg_y = torch.topk(sim.t(), kk, dim=1).values.mean(dim=1)
    return _margin_scores(sim, avg_x, avg_y, margin).argmax(dim=1)


def xsim(x: Any, y: Any, k: int = 4, margin: str = "ratio", device: Any = None) -> float:
    """xsim error rate (%) of margin-based nearest-neighbour alignment.

    x, y: parallel [N, D] embedding matrices (row i of x translates row i of
    y). Lower is better; 0.0 = perfect retrieval.
    """
    dev = resolve_device(device)
    pred = _dense_xsim_pred(_as_f32(x, dev), _as_f32(y, dev), k, margin).cpu().numpy()
    return float((pred != np.arange(len(pred))).mean() * 100.0)


def sharded_xsim(x: Any, y: Any, mesh: Any, k: int = 4, margin: str = "ratio",
                 axis: str = "data", dot_dtype: Any = None, approx: bool = False,
                 device: Any = None) -> float:
    """xsim from the sharded top-k lists alone: the [N, N] similarity never
    exists. Both directions' top k (scores and neighbourhood averages) come
    from ``sharded_cosine_topk``, and each query's margin is taken over its
    cosine top-k candidates only (the LASER mining approximation, which
    equals dense xsim on embeddings whose margin argmax lies in the top k).
    ``dot_dtype`` / ``approx`` as in ``cosine_topk``."""
    dev = resolve_device(device)
    xq, yq = _as_f32(x, dev), _as_f32(y, dev)
    k = min(k, xq.shape[0], yq.shape[0])
    s_xy, i_xy = (t.cpu().numpy() for t in sharded_cosine_topk(
        xq, yq, k, mesh, axis, dot_dtype=dot_dtype, approx=approx, device=dev))
    s_yx = sharded_cosine_topk(yq, xq, k, mesh, axis, dot_dtype=dot_dtype, approx=approx,
                               device=dev)[0].cpu().numpy()
    m = _candidate_margins(s_xy, i_xy, s_xy.mean(axis=1), s_yx.mean(axis=1), margin)
    pred = i_xy[np.arange(len(i_xy)), m.argmax(axis=1)]
    return float((pred != np.arange(len(i_xy))).mean() * 100.0)


def sharded_xsim_pp(x: Any, y: Any, y_distractors: Any, mesh: Any, k: int = 4,
                    margin: str = "ratio", axis: str = "data", dot_dtype: Any = None,
                    approx: bool = False, device: Any = None) -> float:
    """``sharded_xsim`` over y with the distractors appended (xsim++)."""
    dev = resolve_device(device)
    y_all = torch.cat([_as_f32(y, dev), _as_f32(y_distractors, dev)], dim=0)
    return sharded_xsim(x, y_all, mesh, k=k, margin=margin, axis=axis, dot_dtype=dot_dtype,
                        approx=approx, device=dev)


def xsim_pp(x: Any, y: Any, y_distractors: Any, k: int = 4, margin: str = "ratio",
            device: Any = None) -> float:
    """xsim++: the xsim protocol with distractor targets appended to y (a
    distractor pick is an error like any other wrong index)."""
    dev = resolve_device(device)
    y_all = torch.cat([_as_f32(y, dev), _as_f32(y_distractors, dev)], dim=0)
    return xsim(x, y_all, k=k, margin=margin, device=dev)


def mine_bitexts(
    x: Any,
    y: Any,
    k: int = 4,
    margin: str = "ratio",
    strategy: str = "intersection",
    threshold: Optional[float] = None,
    mesh: Any = None,
    axis: str = "data",
    approx: bool = False,
    dot_dtype: Any = None,
    device: Any = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LASER-style margin-based bitext mining over the SONAR space.

    Candidates come from ``cosine_topk`` in both directions (``dot_dtype``
    and ``approx`` as there), margins follow the LASER definition (ratio,
    distance, absolute over k-NN-average neighbourhoods), and pairs are
    selected by ``strategy``:

    - ``'forward'``: each x row proposes its best-margin y candidate,
    - ``'backward'``: each y row proposes its best-margin x candidate,
    - ``'intersection'``: mutual best matches only (highest precision),
    - ``'union'``: forward + backward pairs, deduplicated keeping the max
      score (highest recall).

    Returns ``(src_idx, tgt_idx, scores)`` (numpy) sorted by descending
    margin score, the sort stable; ``threshold`` keeps ``score >=
    threshold``. ``mesh`` (and ``axis``) take both directions' candidates
    from ``sharded_cosine_topk``, the bank split over that mesh axis.
    """
    if strategy not in ("forward", "backward", "intersection", "union"):
        raise ValueError(f"unknown strategy: {strategy}")
    dev = resolve_device(device)
    xq, yq = _as_f32(x, dev), _as_f32(y, dev)
    k = min(k, xq.shape[0], yq.shape[0])

    def topk(q: torch.Tensor, b: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        if mesh is None:
            out = cosine_topk(q, b, k, dot_dtype=dot_dtype, approx=approx, device=dev)
        else:
            out = sharded_cosine_topk(q, b, k, mesh, axis, dot_dtype=dot_dtype,
                                      approx=approx, device=dev)
        return out[0].cpu().numpy(), out[1].cpu().numpy()

    s_xy, i_xy = topk(xq, yq)
    s_yx, i_yx = topk(yq, xq)
    avg_x = s_xy.mean(axis=1)                            # [Nx]
    avg_y = s_yx.mean(axis=1)                            # [Ny]

    def best(scores, idx, avg_q, avg_b):
        """Per-query best margin candidate among its cosine top-k."""
        m = _candidate_margins(scores, idx, avg_q, avg_b, margin)
        pick = m.argmax(axis=1)
        rows = np.arange(len(idx))
        return idx[rows, pick], m[rows, pick]

    fwd_j, fwd_s = best(s_xy, i_xy, avg_x, avg_y)        # x_i -> y_{fwd_j[i]}
    bwd_i, bwd_s = best(s_yx, i_yx, avg_y, avg_x)        # y_j -> x_{bwd_i[j]}

    nx, ny = len(fwd_j), len(bwd_i)
    if strategy == "forward":
        src, tgt, sc = np.arange(nx), fwd_j, fwd_s
    elif strategy == "backward":
        src, tgt, sc = bwd_i, np.arange(ny), bwd_s
    elif strategy == "intersection":
        mutual = bwd_i[fwd_j] == np.arange(nx)
        src = np.arange(nx)[mutual]
        tgt, sc = fwd_j[mutual], fwd_s[mutual]
    else:  # union
        src = np.concatenate([np.arange(nx), bwd_i])
        tgt = np.concatenate([fwd_j, np.arange(ny)])
        sc = np.concatenate([fwd_s, bwd_s])
        # dedup (src, tgt) keeping the max score
        key = src.astype(np.int64) * max(ny, 1) + tgt
        order = np.lexsort((-sc, key))
        key, src, tgt, sc = key[order], src[order], tgt[order], sc[order]
        keep = np.concatenate([[True], key[1:] != key[:-1]])
        src, tgt, sc = src[keep], tgt[keep], sc[keep]

    if threshold is not None:
        keep = sc >= threshold
        src, tgt, sc = src[keep], tgt[keep], sc[keep]
    order = np.argsort(-sc, kind="stable")
    return src[order].astype(np.int64), tgt[order].astype(np.int64), sc[order]
