"""Faults planted in the program for ``run.py --fault NAME``: each shows that
``correct`` catches what it breaks, at a cell's own size on the card (the
readings that set the upper end of a limit, ``PERF.md``) and in the CPU
tests. Not for measured runs.

- ``shortlist``: the beam search's per-row shortlist of candidates is taken
  over every ``STRIDE``-th column of the vocabulary only, an approximate
  top-k that keeps the wrong candidates; each hypothesis still scores its
  own tokens consistently, so only the selection check (``pick_gap``) can
  see it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

STRIDE = 64


def _shortlist() -> Callable[[], None]:
    from sonar_tpu_torch.generation import beam_search

    exact = beam_search.exact_top_k_wide

    def strided(x: Any, k: int, *args: Any, **kwargs: Any):
        vals, idx = exact(x[..., ::STRIDE].contiguous(), k, *args, **kwargs)
        return vals, idx * STRIDE

    beam_search.exact_top_k_wide = strided
    return lambda: setattr(beam_search, "exact_top_k_wide", exact)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {"shortlist": _shortlist}


def plant(name: str) -> Callable[[], None]:
    """Plant the fault ``name``; returns the call that takes it out."""
    if name not in FAULTS:
        raise KeyError(f"no fault {name!r}: {sorted(FAULTS)}")
    return FAULTS[name]()
