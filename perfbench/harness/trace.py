"""The traced sub-window of a ``--trace 1`` run, reduced in memory.

``Tracer`` profiles one steady unit of the window (whole batches or whole
decodes) with ``torch.profiler`` (CPU and CUDA activities) and reduces its
events at once: no trace file is written. ``Summary`` holds

- ``busy_s``: the union of the device operations' intervals (kernels,
  copies, sets), not their sum: operations that overlap count once;
- ``window_s``: the unit's wall time, from a synchronised start to a
  synchronised end;
- the kernels in time order, for the per-layer readers (``kernels``);
- the device time by operation name and the longest idle gaps, each named
  by the innermost host operation running at its middle (``breakdown``).

Kernels a CUDA graph's conditional loop runs are not in the profiler's
trace (the beam search's); a driver times them with CUDA events instead
(``Tracer(extra=...)``).
"""

from __future__ import annotations

from dataclasses import dataclass
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

TOP = 10
NAME_CHARS = 160


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]        # (name, start s, duration s), by start
    device_ops: List[Tuple[str, float]]            # device seconds by name, longest first
    idle_gaps: List[Tuple[str, float]]             # longest gaps, named by the host


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def summarize(device_events: Sequence[Tuple[str, float, float]],
              host_events: Sequence[Tuple[str, float, float]],
              window: Tuple[float, float]) -> Summary:
    """``device_events`` and ``host_events``: (name, start s, end s) on one
    clock; ``window``: the traced (start, end) on that clock."""
    lo, hi = window
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events if e > lo and s < hi]
    spans = merged([(s, e) for _, s, e in dev])
    busy = sum(e - s for s, e in spans)
    by_name: Dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    gaps, prev = [], lo
    for s, e in spans:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:TOP]:
        mid = (s + e) / 2
        inner = None
        for n, hs, he in host_events:
            if hs <= mid <= he and (inner is None or he - hs < inner[1]):
                inner = (n, he - hs)
        named.append(((inner[0] if inner else "host: no operation recorded")[:NAME_CHARS],
                      e - s))
    kernels = sorted(((n, s, e - s) for n, s, e in dev if not _is_copy(n)), key=lambda k: k[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return Summary(window_s=hi - lo, busy_s=busy, kernels=kernels,
                   device_ops=[(n[:NAME_CHARS], t) for n, t in ops[:TOP]], idle_gaps=named)


def breakdown(summary: Summary) -> dict:
    return {"device_ops": [[n, t] for n, t in summary.device_ops],
            "idle_gaps": [[n, t] for n, t in summary.idle_gaps]}


def _events(prof: Any) -> Tuple[list, list]:
    """(device, host) events of a stopped profiler as (name, start s, end s)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        rec = (e.name(), s, s + e.duration_ns() * 1e-9)
        if str(e.device_type()).endswith("CPU"):
            host.append(rec)
        elif not e.is_user_annotation():  # a host span's image on the device's timeline
            dev.append(rec)
    return dev, host


class Tracer:
    """``with Tracer(torch, device) as t:`` profiles the body; ``t.summary``
    after it. A no-op (``summary`` None) when ``on`` is false.

    The profiler records the kernels of the thread that starts it, and in
    this environment none of those a CUDA graph's conditional loop runs:
    ``extra(t0)``, called once the body has synchronised, returns device
    intervals timed another way ((name, start s, end s) on the host's clock,
    ``t0`` the body's start there), which join the profiler's."""

    def __init__(self, torch: Any, device: Any, on: bool = True,
                 extra: Optional[Callable[[float], List[Tuple[str, float, float]]]] = None):
        self.torch, self.device, self.on, self.extra = torch, device, on, extra
        self.summary: Optional[Summary] = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def __enter__(self) -> "Tracer":
        if self.on:
            acts = [self.torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(self.torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self.prof = self.torch.profiler.profile(activities=acts)
            self.prof.start()
            self._sync()
            self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc: Any) -> None:
        if not self.on:
            return
        self._sync()
        t1_ns = time.time_ns()
        self.prof.stop()
        if exc[0] is not None:
            return
        dev, host = _events(self.prof)
        if self.extra is not None:
            dev += self.extra(self.t0_ns * 1e-9)
        # Both ends were synchronised, so every device operation of the body
        # lies between them; the window also holds each one whole should
        # the profiler's clock stand a little off the host's.
        lo = min([self.t0_ns * 1e-9] + [s for _, s, _ in dev])
        hi = max([t1_ns * 1e-9] + [e for _, _, e in dev])
        self.summary = summarize(dev, host, (lo, hi))
        del self.prof
