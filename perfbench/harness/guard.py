"""The modules no run of the benchmark may load: JAX and the JAX package.

A module is matched by its top-level name (the part before the first dot)
as a whole, so ``sonar_tpu_torch`` is not ``sonar_tpu``."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sonar_tpu"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The sorted forbidden top-level names among ``names``."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
