"""Profiling / tracing helpers (``sonar_tpu.utils.profiling`` on PyTorch).

- ``trace(log_dir)``: record host and device activity with
  ``torch.profiler`` and write a Chrome trace (``trace.json``, viewable in
  Perfetto or ``chrome://tracing``) into ``log_dir``,
- ``annotate(name)``: a named region on that trace's timeline
  (``torch.profiler.record_function``),
- ``Timer``: wall timing that ends each sample only once every output is
  on the host (or the card has finished): a CUDA call returns as soon as
  its work is queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Profile the block (CPU activity, and CUDA activity where a card is
    present); the trace goes to ``log_dir/trace.json``. Yields the
    profiler, whose ``key_averages()`` sums time by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> Any:
    """Named region on the profiler's timeline."""
    return torch.profiler.record_function(name)


def _materialize(out: Any) -> None:
    """Copy every tensor in ``out`` (nested lists, tuples, dicts) to the
    host, which waits for the device work that produced it."""
    if isinstance(out, torch.Tensor):
        out.cpu()
    elif isinstance(out, dict):
        for v in out.values():
            _materialize(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _materialize(v)


class Timer:
    """Times callables with every output materialised on the host."""

    def __init__(self):
        self.samples: list = []

    def measure(self, fn: Any, *args: Any, iters: int = 5) -> float:
        _materialize(fn(*args))  # warmup
        for _ in range(iters):
            t0 = time.perf_counter()
            _materialize(fn(*args))
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.samples.append(time.perf_counter() - t0)
        return self.p50

    @property
    def p50(self) -> float:
        s = sorted(self.samples)
        return s[len(s) // 2] if s else float("nan")

    @property
    def best(self) -> float:
        return min(self.samples) if self.samples else float("nan")
