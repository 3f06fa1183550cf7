"""Sequence packing for the text encoder (no padding between sentences).

The port's copy of ``sonar_tpu.data.packing`` (numpy only). Length-bucketed
batching still pads within each bucket; packing removes that padding:
several sentences share one fixed-length row, attention is block-diagonal
per segment, positions restart per segment (the legacy PE offset is applied
on top), and pooling reduces each segment separately. One shape serves the
whole corpus. ``SonarTextEncoder.apply_packed`` encodes the batches; static
batching (``batching="static"``) stays the serving default.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclass
class PackedBatch:
    tokens: np.ndarray        # [B, L] int32
    segment_ids: np.ndarray   # [B, L] int32; 0 = padding, 1..K = segments
    positions: np.ndarray     # [B, L] int32; restart at 0 per segment
    # (original_index, row, segment_id) for every sentence in this batch.
    mapping: List[Tuple[int, int, int]]
    max_segments: int


def pack_sequences(
    token_lists: Sequence[Sequence[int]],
    row_len: int = 128,
    rows_per_batch: int = 64,
    max_segments: int = 16,
) -> Iterator[PackedBatch]:
    """Greedy first-fit packing into [rows_per_batch, row_len] batches.

    Sentences longer than ``row_len`` are truncated. Returns batches whose
    ``mapping`` lists (row, segment) per input sentence in input order.
    """
    n = len(token_lists)
    if any(len(t) == 0 for t in token_lists):
        # A zero-length sentence would get a segment id with no cells in
        # segment_ids — per-segment pooling would silently reduce over an
        # empty mask (NaN embedding). The unpacked path never sees this
        # either (the tokenizer always emits at least a language token).
        raise ValueError("pack_sequences: zero-length sequences not packable")
    order = sorted(range(n), key=lambda i: -len(token_lists[i]))

    rows: List[List[int]] = []          # flat token storage per row
    row_segs: List[List[Tuple[int, int]]] = []  # per row: list of (orig_idx, len)

    for idx in order:
        item = list(token_lists[idx])[:row_len]
        placed = False
        # first-fit over open rows (bounded scan window keeps this O(n*w))
        for r in range(max(0, len(rows) - 64), len(rows)):
            if len(rows[r]) + len(item) <= row_len and len(row_segs[r]) < max_segments:
                rows[r].extend(item)
                row_segs[r].append((idx, len(item)))
                placed = True
                break
        if not placed:
            rows.append(list(item))
            row_segs.append([(idx, len(item))])

    for start in range(0, len(rows), rows_per_batch):
        chunk = list(range(start, min(start + rows_per_batch, len(rows))))
        b = len(chunk)
        tokens = np.zeros((rows_per_batch, row_len), np.int32)
        seg = np.zeros((rows_per_batch, row_len), np.int32)
        pos = np.zeros((rows_per_batch, row_len), np.int32)
        mapping: List[Tuple[int, int, int]] = []
        for local_r, r in enumerate(chunk):
            cursor = 0
            for s_i, (orig, length) in enumerate(row_segs[r], start=1):
                tokens[local_r, cursor : cursor + length] = rows[r][cursor : cursor + length]
                seg[local_r, cursor : cursor + length] = s_i
                pos[local_r, cursor : cursor + length] = np.arange(length)
                mapping.append((orig, local_r, s_i))
                cursor += length
        mapping.sort(key=lambda t: t[0])
        yield PackedBatch(
            tokens=tokens,
            segment_ids=seg,
            positions=pos,
            mapping=mapping,
            max_segments=max_segments,
        )
