"""Static-shape batching: the TPU-optimal batching strategy.

``dynamic_bucket`` (reference semantics) budgets *real* tokens, but XLA
executes *padded* shapes — with a pow2 batch pad on top, worst-case waste
approaches 2x. ``StaticShapeBatcher`` instead fixes one (batch, len) shape
per length bucket with a constant padded-token budget, fills batches
completely (remainders are the only padding), and so keeps both the
compilation count AND the padding waste minimal.

Used by bench.py; available to pipelines via ``batching="static"``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
from sonar_tpu_torch.data.collate import SequenceBatch
from sonar_tpu_torch.utils.profiling import span

# The fewest rows a batch holds, however long its bucket.
MIN_BATCH = 8


class StaticShapeBatcher:
    def __init__(
        self,
        pad_value: int,
        len_buckets: Sequence[int] = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512),
        tokens_per_batch: int = 16384,
    ):
        self.pad_value = pad_value
        self.len_buckets = tuple(sorted(len_buckets))
        self.tokens_per_batch = tokens_per_batch

    def bucket_of(self, n: int) -> int:
        for b in self.len_buckets:
            if n <= b:
                return b
        return self.len_buckets[-1]

    def batch_size_for(self, bucket: int) -> int:
        b = max(MIN_BATCH, self.tokens_per_batch // bucket)
        return max(MIN_BATCH, (b // 8) * 8)  # sublane-friendly batch

    def batches(
        self,
        token_lists: Iterable[Sequence[int]],
        yield_indices: bool = False,
    ) -> Iterator:
        """Group by length bucket, emit full [B_bucket, bucket] batches.

        Items within a bucket keep arrival order; buckets flush when full
        and at the end (remainder rows are batch padding). With
        ``yield_indices`` each yield is ``(batch, input_positions)`` so a
        caller can restore input order across the bucket interleaving.
        """
        pending: Dict[int, list] = {b: [] for b in self.len_buckets}
        for pos, item in enumerate(token_lists):
            item = (pos, list(item)[: self.len_buckets[-1]])
            b = self.bucket_of(len(item[1]))
            pending[b].append(item)
            if len(pending[b]) >= self.batch_size_for(b):
                yield self._make(pending[b], b, yield_indices)
                pending[b] = []
        # Flush: ascending buckets; sparsely-filled remainders promote to the
        # nearest longer bucket that has a partial batch of its own, when
        # the added length padding is cheaper than the empty rows of a
        # dedicated batch: a few extra pad tokens per item beat a
        # mostly-empty full-shape batch. (Into a bucket with no partial
        # batch they would fill a batch of their own, of about the same
        # padded tokens with longer rows: no row saved, and more attention
        # work.)
        for bi, b in enumerate(self.len_buckets):
            items = pending[b]
            if not items:
                continue
            bsz = self.batch_size_for(b)
            while len(items) >= bsz:
                yield self._make(items[:bsz], b, yield_indices)
                items = items[bsz:]
            if not items:
                continue
            nb = next((c for c in self.len_buckets[bi + 1:]
                       if len(pending[c]) % self.batch_size_for(c)), None)
            if nb is not None:
                # cost of emitting the partial batch here = its empty rows;
                # cost of promoting = the extra per-item length padding
                # (the items then fill nb's batch; cascades greedily).
                own_cost = (bsz - len(items)) * b
                promote_cost = len(items) * (nb - b)
                if promote_cost < own_cost:
                    pending[nb] = items + pending[nb]
                    continue
            yield self._make(items, b, yield_indices)

    def _make(self, items: List[Tuple[int, Sequence[int]]], bucket: int,
              yield_indices: bool):
        bsz = self.batch_size_for(bucket)
        with span("pipeline.batch", bucket=bucket, used=len(items), rows=bsz) as s:
            seqs = np.full((bsz, bucket), self.pad_value, np.int32)
            lens = np.zeros((bsz,), np.int32)
            for i, (_, it) in enumerate(items):
                seqs[i, : len(it)] = np.asarray(it, np.int32)
                lens[i] = len(it)
            s.set(tokens=int(lens.sum()))
        batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=len(items))
        if yield_indices:
            return batch, np.asarray([pos for pos, _ in items], np.int64)
        return batch


def optimal_len_buckets(
    lengths: Sequence[int],
    k: int = 32,
    max_len: Optional[int] = None,
) -> Tuple[int, ...]:
    """K bucket boundaries minimizing total padded tokens for ``lengths``.

    Exact dynamic program over the length histogram: ``dp[j][k]`` = minimal
    padded tokens covering lengths <= j with k buckets whose last boundary
    is j (every item pads up to its bucket's boundary); vectorized to one
    [L, L] broadcast argmin per k-round (~ms at sentence lengths). A
    deployment serving a stationary traffic distribution tunes its static
    bucket set with this; the returned boundaries always include the
    observed (or given) maximum so every input fits. Zero-length items
    cost one padded row of the first bucket (``StaticShapeBatcher`` still
    emits a row for them), so they are modeled as length 1.

    Only length-rounding waste is modeled; remainder-batch waste (the last
    partial batch per bucket) grows with k, so past ~k=40 the marginal
    rounding gain loses to fragmentation — measure end-to-end via
    ``TorchTextEncoder.stats`` when picking k.
    """
    lens = np.asarray(list(lengths), np.int64)
    if lens.size == 0:
        raise ValueError("lengths must be non-empty")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    # all-zero lengths still need one bucket of length >= 1 (see below)
    top = int(max_len) if max_len is not None else max(1, int(lens.max()))
    if top < 1:
        raise ValueError(f"maximum length must be >= 1, got {top}")
    # an empty sequence still occupies a padded row in its bucket
    lens = np.clip(lens, 1, top)
    cnt = np.bincount(lens, minlength=top + 1).astype(np.int64)
    pc = np.concatenate([[0], np.cumsum(cnt)])  # pc[j] = count(len < j)

    # Optimal boundaries only ever sit at OBSERVED lengths (lowering a
    # boundary to the next observed length below it never increases any
    # item's padding), except the final boundary which must be `top` so
    # every input fits — so the DP runs over the <=N unique values, not
    # all L positions (O(U^2 K) instead of O(L^2 K); L=65536 would cost
    # a ~34 GB [L, L] table or minutes of chunked loops).
    vals = np.flatnonzero(cnt).astype(np.int64)     # sorted unique lengths
    if vals[-1] != top:
        vals = np.append(vals, top)
    m = len(vals)
    k = min(k, m)
    # count of items with length in (vals[i], vals[j]] = cum[j] - cum[i]
    cum = np.cumsum(cnt[vals])                      # items with len <= vals[i]
    cum0 = np.concatenate([[0], cum])               # cum0[i] = items <= vals[i-1]

    INF = np.int64(1) << 60
    # dp[i]: minimal cost covering all lengths <= vals[i-1] (i=0: none)
    dp_prev = np.full(m + 1, INF)
    dp_prev[0] = 0
    parent = np.zeros((k + 1, m + 1), np.int32)
    ai = np.arange(m + 1)
    for ki in range(1, k + 1):
        # costs[a, j] = dp_prev[a] + (cum0[j+1] - cum0[a]) * vals[j], a <= j
        costs = np.where(
            (ai[:, None] <= np.arange(m)[None, :]) & (dp_prev[ai, None] < INF),
            dp_prev[ai, None] + (cum0[None, 1:] - cum0[ai, None]) * vals[None, :],
            INF,
        )
        best = np.argmin(costs, axis=0)             # [m]
        dp_cur = np.full(m + 1, INF)
        dp_cur[1:] = costs[best, np.arange(m)]
        parent[ki, 1:] = best
        dp_prev = dp_cur

    bounds = []
    j, ki = m, k
    while j > 0 and ki > 0:
        bounds.append(int(vals[j - 1]))
        j = int(parent[ki, j])
        ki -= 1
    return tuple(sorted(set(bounds)))
