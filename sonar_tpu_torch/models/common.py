"""Shared model-layer types: vocabulary info, encoder output, arch registry.

Counterpart of ``sonar_tpu.models.common`` without the JAX pytree
registration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Generic, Optional, TypeVar

import torch


@dataclass(frozen=True)
class VocabularyInfo:
    size: int
    unk_idx: Optional[int]
    bos_idx: Optional[int]
    eos_idx: Optional[int]
    pad_idx: Optional[int]


@dataclass
class SonarEncoderOutput:
    """Output of every SONAR encoder.

    encoded_seqs: [N, S, M]; sentence_embeddings: [N, M];
    seq_lens: [N] int32 or None (all valid).
    """

    encoded_seqs: torch.Tensor
    sentence_embeddings: torch.Tensor
    seq_lens: Optional[torch.Tensor]


C = TypeVar("C")


class ConfigRegistry(Generic[C]):
    """Named architecture registry."""

    def __init__(self, name: str):
        self.name = name
        self._archs: Dict[str, Callable[[], C]] = {}

    def arch(self, name: str) -> Callable[[Callable[[], C]], Callable[[], C]]:
        def deco(fn: Callable[[], C]) -> Callable[[], C]:
            self._archs[name] = fn
            return fn

        return deco

    def get(self, name: str) -> C:
        if name not in self._archs:
            raise KeyError(
                f"unknown {self.name} arch '{name}'; known: {sorted(self._archs)}"
            )
        return self._archs[name]()
