"""Padding collation with TPU shape bucketing.

Replaces fairseq2n's C++ ``Collater(pad_value, pad_to_multiple)`` (reference
``sonar/inference_pipelines/text.py:241``, ``speech.py:136``) and adds the
TPU-critical part: **static shape buckets**. XLA compiles one program per
distinct (batch, seq_len) shape, so the collater rounds sequence length up
to a bucket boundary and batch size up to a power of two, bounding the
number of compilations to |len_buckets| x |batch_buckets| for the whole run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from sonar_tpu_torch.utils.profiling import span

DEFAULT_LEN_BUCKETS = (16, 32, 64, 128, 256, 512, 514)


def round_up_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def round_up_pow2(n: int, cap: Optional[int] = None) -> int:
    p = 1
    while p < n:
        p <<= 1
    if cap is not None:
        p = min(p, cap)
    return max(p, n if cap is None else min(n, cap))


@dataclass
class SequenceBatch:
    """Right-padded token batch + true lengths + true batch size.

    ``seqs`` [B_pad, S_bucket] int32; ``seq_lens`` [B_pad] int32 (0 for
    padding rows); ``true_batch`` rows are real, the rest is shape padding.
    """

    seqs: np.ndarray
    seq_lens: np.ndarray
    true_batch: int


class Collater:
    def __init__(
        self,
        pad_value: int,
        pad_to_multiple: int = 1,
        len_buckets: Optional[Sequence[int]] = None,
        pad_batch_to_pow2: bool = True,
    ):
        self.pad_value = pad_value
        self.pad_to_multiple = pad_to_multiple
        self.len_buckets = tuple(len_buckets) if len_buckets else None
        self.pad_batch_to_pow2 = pad_batch_to_pow2

    def __call__(self, items: List[Sequence[int]]) -> SequenceBatch:
        b = len(items)
        lens = [len(x) for x in items]
        max_len = max(lens) if lens else 1
        max_len = max(max_len, 1)
        if self.pad_to_multiple > 1:
            m = self.pad_to_multiple
            max_len = ((max_len + m - 1) // m) * m
        if self.len_buckets:
            max_len = round_up_length(max_len, self.len_buckets)
        b_pad = round_up_pow2(b) if self.pad_batch_to_pow2 else b

        with span("pipeline.batch", bucket=max_len, used=b, rows=b_pad, tokens=sum(lens)):
            seqs = np.full((b_pad, max_len), self.pad_value, np.int32)
            for i, item in enumerate(items):
                seqs[i, : lens[i]] = np.asarray(item, np.int32)
            seq_lens = np.zeros((b_pad,), np.int32)
            seq_lens[:b] = np.asarray(lens, np.int32)
        return SequenceBatch(seqs=seqs, seq_lens=seq_lens, true_batch=b)


class FeatureCollater:
    """Collate [T_i, F] float feature arrays (fbank) into [B, T_pad, F]."""

    def __init__(
        self,
        pad_to_multiple: int = 1,
        len_buckets: Optional[Sequence[int]] = None,
        pad_batch_to_pow2: bool = True,
    ):
        self.pad_to_multiple = pad_to_multiple
        self.len_buckets = tuple(len_buckets) if len_buckets else None
        self.pad_batch_to_pow2 = pad_batch_to_pow2

    def __call__(self, items: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, int]:
        b = len(items)
        lens = [x.shape[0] for x in items]
        feat = items[0].shape[1]
        max_len = max(max(lens), 1)
        if self.pad_to_multiple > 1:
            m = self.pad_to_multiple
            max_len = ((max_len + m - 1) // m) * m
        if self.len_buckets:
            max_len = round_up_length(max_len, self.len_buckets)
        b_pad = round_up_pow2(b) if self.pad_batch_to_pow2 else b
        out = np.zeros((b_pad, max_len, feat), items[0].dtype)
        for i, x in enumerate(items):
            out[i, : lens[i]] = x
        seq_lens = np.zeros((b_pad,), np.int32)
        seq_lens[:b] = np.asarray(lens, np.int32)
        return out, seq_lens, b
