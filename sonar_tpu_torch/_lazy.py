"""Module-level ``__getattr__`` for a package's lazy exports."""

from __future__ import annotations

import importlib
from typing import Callable, Dict


def lazy_exports(package: str, names: Dict[str, str]) -> Callable[[str], object]:
    """A ``__getattr__`` that resolves ``names`` (export -> ``module`` or
    ``module:attribute``, relative to ``package``) on first use."""

    def __getattr__(name: str) -> object:
        if name not in names:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        module, _, attr = names[name].partition(":")
        return getattr(importlib.import_module(f"{package}.{module}"), attr or name)

    return __getattr__
