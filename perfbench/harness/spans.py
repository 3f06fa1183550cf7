"""Spans the benchmark records around the program's layer boundaries, from
its own files: it wraps a method of the runtime object it was handed (an
instance attribute, so the class is untouched) and names the call in the
profiler's trace. Only a ``--trace 1`` run records them."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np


def wrap(obj: Any, method: str, span: str, after: Callable[..., None]) -> None:
    """Replace ``obj.method`` by a call that runs inside the profiler range
    ``span`` and then passes (args, kwargs, result) to ``after``."""
    import torch

    inner = getattr(obj, method)

    def call(*args: Any, **kwargs: Any) -> Any:
        with torch.profiler.record_function(span):
            out = inner(*args, **kwargs)
        after(args, kwargs, out)
        return out

    setattr(obj, method, call)


class Batches:
    """The padded shape and the true lengths of every batch a
    ``TorchTextEncoder`` encodes (``encode_batch``: the runtime layer)."""

    def __init__(self, encoder: Any):
        self.shapes: List[tuple] = []
        self.lens: List[np.ndarray] = []
        wrap(encoder, "encode_batch", "runtime.encode_batch", self._record)

    def _record(self, args: tuple, kwargs: dict, out: Any) -> None:
        batch = args[0] if args else kwargs["batch"]
        self.shapes.append(tuple(batch.seqs.shape))
        self.lens.append(np.asarray(batch.seq_lens)[: batch.true_batch].copy())

    def mark(self) -> int:
        return len(self.shapes)
