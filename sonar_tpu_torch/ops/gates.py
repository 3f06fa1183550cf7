"""What every kernel gate of the port reads besides shapes.

The CUDA kernels (like the Pallas kernels they replace) have no backward:
an output they write carries no gradient path. Run on tensors that autograd
records, a kernel would give a loss whose gradients skip it (the attention
weights before it would get none) and raise no error. So each gate takes
the plain PyTorch version whenever autograd records, which computes the same
function with a backward. Under ``torch.no_grad()`` or
``torch.inference_mode()`` (every runtime's forward) nothing changes.
"""

from __future__ import annotations

from typing import Optional

import torch


def records_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """True when autograd is on and any of ``tensors`` (None skipped)
    requires grad: the kernel's output would need a backward."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
