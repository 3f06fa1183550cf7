"""Shared model-layer types: vocabulary info, encoder output, parameter
tree, arch registry.

Counterpart of ``sonar_tpu.models.common`` without the JAX pytree
registration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

import torch
from torch import nn


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


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``: one sub-module per
    dict, one (persistent) buffer per tensor. ``tree()`` gives the dict back
    with the module's current tensors (after ``.to(device)`` too)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, ParamTree(value))
            else:
                self.register_buffer(key, value)

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key in self._keys:
            value = getattr(self, key)
            out[key] = value.tree() if isinstance(value, ParamTree) else value
        return out


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

    def names(self) -> list:
        return sorted(self._archs)
