"""The measured window of a driver that calls its entry point on chunk after
chunk: units of whole calls, run until ``seconds`` have passed. In a
``--trace 1`` run the second unit (a steady one) is profiled; the
per-layer metrics that are rates are read over the other units, which the
profiler did not slow."""

from __future__ import annotations

from dataclasses import dataclass, field
import time
from typing import Any, Callable, Dict, List, Optional

from perfbench.harness import devices
from perfbench.harness.trace import Summary, Tracer

TRACED_UNIT = 1


@dataclass
class Unit:
    index: int
    seconds: float
    traced: bool
    out: Any
    counts: Dict[str, float] = field(default_factory=dict)  # counters' change over the unit


@dataclass
class Window:
    start: float
    end: float
    units: List[Unit]
    summary: Optional[Summary]

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def untraced(self) -> List[Unit]:
        return [u for u in self.units if not u.traced]

    def traced(self) -> Optional[Unit]:
        return next((u for u in self.units if u.traced), None)


def chunked(torch: Any, device: Any, seconds: float, trace: bool,
            call: Callable[[int], Any], counters: Callable[[], Dict[str, float]],
            extra: Optional[Callable] = None) -> Window:
    """``call(i)`` for i = 0, 1, ... until the window has lasted ``seconds``
    (and the traced unit has run); ``counters()`` is read around each;
    ``extra``: device intervals the profiler cannot see (``Tracer``)."""
    traced_at = TRACED_UNIT if trace else -1
    units: List[Unit] = []
    summary = None
    devices.sync(torch, device)
    start = end = time.perf_counter()
    i = 0
    while True:
        before = counters()
        tracer = Tracer(torch, device, on=i == traced_at, extra=extra)
        t_a = time.perf_counter()
        with tracer:
            out = call(i)
        end = time.perf_counter()
        after = counters()
        units.append(Unit(i, end - t_a, i == traced_at, out,
                          {k: after[k] - before[k] for k in after}))
        if tracer.summary is not None:
            summary = tracer.summary
        i += 1
        if end - start >= seconds and i > traced_at:
            break
    return Window(start, end, units, summary)
