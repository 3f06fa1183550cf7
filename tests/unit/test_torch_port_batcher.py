"""The port's StaticShapeBatcher: the end-of-stream flush promotes a
remainder only into a longer bucket that has a partial batch of its own."""

import numpy as np
import pytest

from sonar_tpu_torch.data.batcher import StaticShapeBatcher
from sonar_tpu_torch.inference_pipelines.text import _static_len_buckets_for


def _items(*lens):
    return [list(range(4, 4 + n)) for n in lens]


def _shapes(batcher, items):
    return [(tuple(b.seqs.shape), b.true_batch) for b in batcher.batches(items)]


def test_remainder_stays_in_its_bucket_when_no_longer_bucket_waits():
    """Sentences of at most 126 tokens under the production buckets (to
    512) at 8,192 tokens a batch: 70 of bucket 128 give one full [64, 128]
    batch and a remainder of 6, which stays at S 128 instead of climbing
    through the empty buckets 192..512 to a [16, 512] batch."""
    b = StaticShapeBatcher(pad_value=1, len_buckets=_static_len_buckets_for(512),
                           tokens_per_batch=8192)
    assert _shapes(b, _items(*[100] * 70)) == [((64, 128), 64), ((64, 128), 6)]


def test_remainder_joins_a_longer_partial_batch():
    """A remainder of 3 in bucket 16 joins bucket 64's partial batch of 2,
    past the empty bucket 32: one [16, 64] batch of 5 rows where the flush
    would otherwise emit two."""
    b = StaticShapeBatcher(pad_value=1, len_buckets=(16, 32, 64), tokens_per_batch=1024)
    assert [b.batch_size_for(n) for n in (16, 32, 64)] == [64, 32, 16]
    assert _shapes(b, _items(10, 10, 10, 50, 50)) == [((16, 64), 5)]


def test_remainder_with_a_full_longer_bucket_stays():
    """Bucket 64's items fill whole batches only: nothing partial to join,
    so bucket 16's remainder is emitted at S 16."""
    b = StaticShapeBatcher(pad_value=1, len_buckets=(16, 64), tokens_per_batch=1024)
    got = _shapes(b, _items(*[50] * 16, 10, 10))
    assert got == [((16, 64), 16), ((64, 16), 2)]


@pytest.mark.parametrize("seed", [0, 1])
def test_flush_batches_every_item_once(seed):
    """Lengths 1..510 over the production buckets: each item lands in one
    row, in a batch of its bucket's shape, at a bucket no shorter than it,
    and the indices restore the input order."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 511, 700)
    items = [list(rng.integers(4, 100, n)) for n in lens]
    b = StaticShapeBatcher(pad_value=1, len_buckets=_static_len_buckets_for(512),
                           tokens_per_batch=8192)
    seen = {}
    for batch, idx in b.batches(items, yield_indices=True):
        bsz, s = batch.seqs.shape
        assert bsz == b.batch_size_for(s) and len(idx) == batch.true_batch
        for row, pos in enumerate(idx):
            n = int(batch.seq_lens[row])
            assert pos not in seen and n == len(items[pos]) <= s
            seen[int(pos)] = list(batch.seqs[row, :n])
    assert sorted(seen) == list(range(len(items)))
    assert all(seen[i] == items[i] for i in seen)
