"""Matmul precision policy for model runtimes.

Counterpart of ``sonar_tpu.ops.precision.matmul_precision_for``: an fp32
model computes true fp32 products. On an NVIDIA card that means no TF32,
neither in cuBLAS matmuls nor in cuDNN; bf16 models run as they are.
``matmul_f32_out`` is the fp32-output product of model-dtype operands that
the tied projection and the half-FFN's plain version share.
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


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of model-dtype operands, summed and returned in fp32 (the TPU
    code's ``preferred_element_type``).

    fp32 operands multiply in fp32. A bf16 product on the card asks cuBLAS
    for an fp32 output of its fp32 accumulator; on the CPU, whose bf16
    matmul rounds its output, the bf16 operands are widened first (their
    products are exact in fp32, so the function is the same).
    """
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()
