"""Hand-written Hopper kernels of the port, one module per TPU kernel of
``sonar_tpu/ops/pallas/``.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``LAUNCHES``, or one per kernel where a module holds
several: ``relpos_flash``, ``beam_attend``). The wrapper runs the plain version for a CPU
tensor only; for a CUDA tensor it launches the kernel (built from
``sonar_tpu_torch/csrc/`` at first use) or raises.

A CUDA graph replay launches again every kernel its capture recorded, and
no wrapper runs then. So a wrapper counts through ``launched``: while its
thread captures (inside ``captured_launches``) the launch goes to the
capture's tally, since a capture launches nothing, and the runtime that
replays the graph adds the tally at each replay (``add_launches``;
``generation.decoder_runtime``'s captured beam search).
"""

from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Dict, Iterator, Tuple

Tally = Dict[Tuple[str, str], int]
_capture = threading.local()


def _module(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def launched(module: str, counter: str) -> None:
    """Count one launch on ``module``'s ``counter`` (``module`` a module of
    this package), or in this thread's capture tally while it captures."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[module, counter] = tally.get((module, counter), 0) + 1
    else:
        mod = _module(module)
        setattr(mod, counter, getattr(mod, counter) + 1)


@contextlib.contextmanager
def captured_launches() -> Iterator[Tally]:
    """Around a CUDA graph capture in this thread: yields the tally of the
    launches it records (what one replay launches), which the counters do
    not see."""
    tally: Tally = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def add_launches(tally: Tally, replays: int = 1) -> None:
    """Count ``replays`` replays of a graph whose one replay launches
    ``tally``."""
    for (module, counter), n in tally.items():
        mod = _module(module)
        setattr(mod, counter, getattr(mod, counter) + n * replays)
