"""What every kernel gate of the port reads besides shapes.

Autograd. The CUDA kernels (like the Pallas kernels they replace) have no
backward: an output they write carries no gradient path. Run on tensors
that autograd records, a kernel would give a loss whose gradients skip it
(the attention weights before it would get none) and raise no error. So
each gate takes the plain PyTorch version whenever autograd records, which
computes the same function with a backward. Under ``torch.no_grad()`` or
``torch.inference_mode()`` (every runtime's forward) nothing changes.

The caller's choice (the JAX package's kernel-selection API,
``sonar_tpu.ops.attention`` and ``sonar_tpu.nn.transformer``):

- ``no_cuda_kernels()`` turns every kernel gate off inside its scope. The
  flag is a ``ContextVar``: scopes nest, and a scope entered in one thread
  is not seen by another. Every gate reads it at call time through one
  predicate, ``kernels_allowed``, which is also the autograd check above.
  ``kernel_gate_scope(disabled)`` is the scope or a null context.
- ``set_attention_impl("auto" | "plain" | "cuda")`` (process-wide, as in
  JAX): ``"plain"`` sends the fused attention (#5, ``ops.attention.
  dispatch_sdpa``) and the rel-pos kernel (#6, ``nn.conformer``) to their
  plain paths; ``"cuda"`` takes #5 at any length its other conditions
  allow (JAX's ``"pallas"``); #6's shape gate holds in every mode.
- ``set_ffn_impl("auto" | "plain")`` (process-wide) governs the standalone
  fused int8 FFN (#3, ``nn.transformer.ffn``) only, not the whole-block
  kernels (#2, #3 with LN). Neither setter governs the short attention (#1)
  or the block kernels up to S 128, as in JAX. Past S 128 #2's attention
  step is #5's two-pass core, so ``"plain"`` keeps the block off there
  (``nn.transformer._block_kernels_eligible``), as JAX's block gate, which
  ends at S 128, leaves such layers to plain attention.

The scope also sends the port's own call sites to their plain versions:
the beam step's masked attend (#8) and the sampling step's draw
(``gumbel_max``, whose plain version draws the same noise). It leaves the
conditional WHILE node of the looped decode (``ops.cuda.graph_loop``) in
use: that node is control flow, not compute, as JAX's scope leaves
``lax.while_loop`` as it is.

A CUDA graph replays the kernels its capture recorded, so a captured
program keys on ``kernel_settings()`` read at call time
(``generation.decoder_runtime``). The encoders run eagerly and read the
settings at each call.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Any, Iterator, Optional, Tuple

import torch

ATTENTION_IMPLS = ("auto", "plain", "cuda")
FFN_IMPLS = ("auto", "plain")

_KERNELS_DISABLED: ContextVar[bool] = ContextVar("cuda_kernels_disabled", default=False)
_ATTENTION_IMPL = "auto"
_FFN_IMPL = "auto"


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd is on and any of ``tensors`` (None skipped)
    requires grad: the kernel's output would need a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def cuda_kernels_disabled() -> bool:
    """True inside a ``no_cuda_kernels()`` scope of this thread."""
    return _KERNELS_DISABLED.get()


@contextlib.contextmanager
def no_cuda_kernels() -> Iterator[None]:
    """Every kernel gate takes its plain path inside this scope."""
    token = _KERNELS_DISABLED.set(True)
    try:
        yield
    finally:
        _KERNELS_DISABLED.reset(token)


def kernel_gate_scope(disabled: bool) -> Any:
    """``no_cuda_kernels()`` if ``disabled``, else a null context."""
    return no_cuda_kernels() if disabled else contextlib.nullcontext()


def kernels_allowed(*tensors: Optional[torch.Tensor]) -> bool:
    """What every gate asks besides its shapes: no ``no_cuda_kernels()``
    scope, and nothing in ``tensors`` that autograd records."""
    return not _KERNELS_DISABLED.get() and not records_grad(*tensors)


def set_attention_impl(impl: str) -> None:
    """The attention backend: ``"auto"`` (the JAX package's gates),
    ``"plain"`` (#5 and #6 never) or ``"cuda"`` (#5 below its length gate
    too)."""
    global _ATTENTION_IMPL
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl: {impl}")
    _ATTENTION_IMPL = impl


def attention_impl() -> str:
    return _ATTENTION_IMPL


def set_ffn_impl(impl: str) -> None:
    """The standalone fused int8 FFN (#3): ``"auto"`` (its gate) or
    ``"plain"`` (never)."""
    global _FFN_IMPL
    if impl not in FFN_IMPLS:
        raise ValueError(f"unknown ffn impl: {impl}")
    _FFN_IMPL = impl


def ffn_impl() -> str:
    return _FFN_IMPL


def kernel_settings() -> Tuple[bool, str, str]:
    """(scope flag, attention impl, ffn impl) as a gate would read them now."""
    return _KERNELS_DISABLED.get(), _ATTENTION_IMPL, _FFN_IMPL
