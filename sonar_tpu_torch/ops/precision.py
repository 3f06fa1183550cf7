"""Matmul precision policy for model runtimes.

Counterpart of ``sonar_tpu.ops.precision.matmul_precision_for``: an fp32
model computes true fp32 products. On an NVIDIA card that means no TF32,
neither in cuBLAS matmuls nor in cuDNN; bf16 models run as they are.
``matmul_f32_out`` is the fp32-output product of model-dtype operands that
the tied projection and the half-FFN's plain version share.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Tuple

import torch


class _Fp32Scope:
    """The process-wide state behind ``matmul_precision_for``: how many fp32
    scopes are open, on any thread, and the flags the first one found."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.depth = 0
        self.saved: Optional[Tuple[bool, bool, str]] = None

    def enter(self) -> None:
        with self.lock:
            if self.depth == 0:
                self.saved = (
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                    torch.get_float32_matmul_precision(),
                )
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                torch.set_float32_matmul_precision("highest")
            self.depth += 1

    def exit(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                matmul, cudnn, precision = self.saved
                torch.backends.cuda.matmul.allow_tf32 = matmul
                torch.backends.cudnn.allow_tf32 = cudnn
                torch.set_float32_matmul_precision(precision)
                self.saved = None


_FP32 = _Fp32Scope()


@contextlib.contextmanager
def matmul_precision_for(dtype: torch.dtype) -> Iterator[None]:
    """Scope in which a model of ``dtype`` runs.

    The three flags it clears (cuBLAS's and cuDNN's TF32 switches and the
    fp32 matmul precision) are global to the process, so the fp32 scopes of
    all threads share one count: the first to enter saves the flags and
    clears them, the last to leave restores them. Every fp32 call thus runs
    without TF32 while any other thread is inside or outside its own scope,
    and the caller's flags are back exactly once no scope is open. A bf16
    scope touches nothing; a bf16 call made while another thread holds an
    fp32 scope open runs its own fp32 products (its softmax, its norms)
    without TF32 too, which is the default anyway. A flag that a thread sets
    while a scope is open is overwritten when the last scope leaves.
    """
    if dtype not in (torch.float32, torch.float64):
        yield
        return
    _FP32.enter()
    try:
        yield
    finally:
        _FP32.exit()


def matmul_f32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of model-dtype operands, summed and returned in fp32 (the TPU
    code's ``preferred_element_type``).

    fp32 operands multiply in fp32. A bf16 product on the card asks cuBLAS
    for an fp32 output of its fp32 accumulator (``torch.mm``'s ``out_dtype``
    form, which has no derivative: ``_MatmulF32Out`` gives it one); on the
    CPU, whose bf16 matmul rounds its output, the bf16 operands are widened
    first (their products are exact in fp32, so the function is the same).
    """
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MatmulF32Out.apply(a, b)
    return a.float() @ b.float()


class _MatmulF32Out(torch.autograd.Function):
    """``torch.mm(a, b, out_dtype=torch.float32)`` of two model-dtype
    matrices with a backward: the fp32 output gradient is rounded to the
    operands' dtype, and each operand's gradient is one product in that
    dtype (fp32 accumulation), as a model-dtype matmul's backward is."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        a, b = ctx.saved_tensors
        g = grad.to(a.dtype)
        return g @ b.t(), a.t() @ g
