"""Profiling and tracing (``sonar_tpu.utils.profiling`` on PyTorch).

- ``span(name, **attrs)``: a named stretch of the program's work. While
  recording is on, each span keeps its name, start and end (on
  ``time.time_ns()``), its thread, its parent (the span open around it in
  its context), a request id (the id of the root span of its context: one
  public call, such as ``predict``, and every span under it, also on the
  threads that call hands work to) and a few attributes (rows, bucket,
  tokens, steps). While a ``torch.profiler`` session is active it also
  opens ``torch.profiler.record_function`` on its own thread, so the
  program's names mark the profiler's timeline; a span given a ``cause`` is
  marked ``name[cause]`` there.
- Recording is on inside ``recording()`` and while a ``torch.profiler``
  session is active (``torch.autograd.profiler._is_profiler_enabled``, a
  process-wide flag). Off, a span site reads three module flags and does
  nothing else: no clock, no ``record_function``.
- ``last_recording()``: the spans of the most recent stretch during which
  recording was on, a ``Recording``. A profiler session's stretch ends at
  the first span site that finds recording off again, or at ``trace``'s
  end: two sessions with no span site between them share one.
- ``innermost(thread)``: the name of the innermost span open on a thread
  (a consumer names its wait after what its producer is doing).
- ``trace(log_dir)``: record host and device activity with
  ``torch.profiler`` and write a Chrome trace (``trace.json``, viewable in
  Perfetto or ``chrome://tracing``) into ``log_dir``, with the spans of
  every thread that the block recorded (the profiler sees only its own
  thread) on their thread ids, and the device's spans on thread 0.
- ``annotate(name)``: the same span, under its older name.
- ``Timer``: wall timing that ends each sample only once every output is
  on the host (or the card has finished): a CUDA call returns as soon as
  its work is queued.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The thread id of spans timed on the device (CUDA events), in ``Span`` and
# in ``trace.json``.
DEVICE_THREAD = 0


@dataclass(frozen=True)
class Span:
    """A finished span; times in ``time.time_ns()`` nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    thread: int               # native thread id; DEVICE_THREAD on the device
    id: int
    parent: Optional[int]     # the id of the span that caused it
    request: int              # the id of its context's root span
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclass
class Recording:
    """The spans of one stretch of recording, in the order they ended;
    ``end_ns`` is None while it lasts."""

    start_ns: int
    end_ns: Optional[int] = None
    spans: List[Span] = field(default_factory=list)

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


_ids = itertools.count(1)
_current: contextvars.ContextVar[Optional["_Live"]] = contextvars.ContextVar(
    "sonar_tpu_torch_span", default=None)
_open: Dict[int, "_Live"] = {}    # thread ident -> innermost recorded span open there
_lock = threading.Lock()
_scopes = 0                       # depth of ``recording()``
_last: Optional[Recording] = None
_auto: Optional[Recording] = None  # the stretch a profiler session opened, while it lasts


def _seal(rec: Recording) -> None:
    rec.end_ns = max((s.end_ns for s in rec.spans), default=rec.start_ns)


def _end_auto() -> None:
    global _auto
    with _lock:
        if _auto is not None:
            _seal(_auto)
            _auto = None


def _stretch() -> Recording:
    """The stretch being recorded: a profiler session opens one at its
    first span (a span that entered as ``recording()`` ended joins the
    stretch that ended)."""
    global _last, _auto
    with _lock:
        if _last is None or (_last.end_ns is not None
                             and _autograd_profiler._is_profiler_enabled):
            _last = _auto = Recording(time.time_ns())
        return _last


class _Off:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_OFF = _Off()


class _Live:
    """A span being recorded (``span`` while recording is on)."""

    __slots__ = ("name", "attrs", "id", "parent", "request", "rec", "ident", "outer",
                 "token", "rf", "start_ns")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs

    def set(self, **attrs: Any) -> None:
        """Add attributes known only once the work is done."""
        self.attrs.update(attrs)

    def child(self, name: str, start_ns: int, end_ns: int, **attrs: Any) -> None:
        """Keep a span of this one's that was timed elsewhere (the device's
        CUDA events, placed on the host's clock) in this span's stretch."""
        self.rec.spans.append(Span(name, start_ns, end_ns, DEVICE_THREAD, next(_ids), self.id,
                                   self.request, attrs))

    def __enter__(self) -> "_Live":
        self.rec = _stretch()
        parent = _current.get()
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        self.ident = threading.get_ident()
        self.outer = _open.get(self.ident)
        _open[self.ident] = self
        self.token = _current.set(self)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            cause = self.attrs.get("cause")
            self.rf = torch.profiler.record_function(
                self.name if cause is None else f"{self.name}[{cause}]")
        self.start_ns = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc: Any) -> bool:
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end_ns = time.time_ns()
        _current.reset(self.token)
        if self.outer is None:
            _open.pop(self.ident, None)
        else:
            _open[self.ident] = self.outer
        self.rec.spans.append(Span(self.name, self.start_ns, end_ns, threading.get_native_id(),
                                   self.id, self.parent, self.request, self.attrs))
        return False


def span(name: str, **attrs: Any) -> Any:
    """``with span("runtime.enqueue", rows=n) as s:`` records the block
    while recording is on; ``s`` is false while it is off, and
    ``s.set(...)`` adds attributes at the end. Attributes are ints or short
    strings; ``cause`` names what the span waited on."""
    if _scopes or _autograd_profiler._is_profiler_enabled:
        return _Live(name, attrs)
    if _auto is not None:
        _end_auto()
    return _OFF


def annotate(name: str) -> Any:
    """Named region on the profiler's timeline: a ``span``."""
    return span(name)


def innermost(thread: threading.Thread) -> Optional[str]:
    """The name of the innermost recorded span open on ``thread`` now."""
    live = _open.get(thread.ident)
    return None if live is None else live.name


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span of every thread until the block ends (nested
    blocks share the outer one's stretch); yields the stretch."""
    global _scopes, _last, _auto
    with _lock:
        if _scopes == 0:
            if _auto is not None:
                _seal(_auto)
                _auto = None
            _last = Recording(time.time_ns())
        _scopes += 1
        rec = _last
    try:
        yield rec
    finally:
        with _lock:
            _scopes -= 1
            if _scopes == 0:
                rec.end_ns = time.time_ns()


def last_recording() -> Optional[Recording]:
    """The most recent stretch of recording (None before the first)."""
    return _last


def _export_spans(path: str, spans: List[Span]) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as complete events of
    this process, each on its thread id."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)  # the profiler's origin of "ts"
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": DEVICE_THREAD,
                   "args": {"name": "device spans (CUDA events)"}})
    for s in spans:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, id=s.id, parent=s.parent, request=s.request)})
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Profile the block (CPU activity, and CUDA activity where a card is
    present); the trace goes to ``log_dir/trace.json``, with the spans the
    block recorded. Yields the profiler, whose ``key_averages()`` sums time
    by operation."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _end_auto()
    t0_ns = time.time_ns()
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    _end_auto()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if _last is not None:  # the block's spans, all in one stretch (the profiler was on)
        _export_spans(path, [s for s in _last.spans if s.start_ns >= t0_ns])


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
