"""Matmul precision policy for model runtimes.

Counterpart of ``sonar_tpu.ops.precision.matmul_precision_for``: an fp32
model computes true fp32 products. On an NVIDIA card that means no TF32,
neither in cuBLAS matmuls nor in cuDNN; bf16 models run as they are.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def matmul_precision_for(dtype: torch.dtype) -> Iterator[None]:
    """Scope in which a model of ``dtype`` runs; restores the flags after."""
    if dtype not in (torch.float32, torch.float64):
        yield
        return
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])
