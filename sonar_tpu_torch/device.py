"""The device the port's entry points run on.

Every loader, runtime and pipeline of the port takes ``device=None`` to mean
the GPU (``cuda``). Without one it raises instead of running on the CPU; the
CPU path (each kernel wrapper's plain PyTorch version) is taken only when
the caller asks for ``device="cpu"``, as the tests do.
"""

from __future__ import annotations

from typing import Any

import torch


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None; raises if that
    is a CUDA device and no GPU is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU unless asked for "
            "the CPU (pass device='cpu' for its plain PyTorch path)"
        )
    return dev


def upload(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``. A host tensor bound for a GPU goes through
    pinned memory without blocking: a copy from pageable memory waits until
    the device has run everything queued before it, which would stop a
    caller from queuing the next batch while this one computes."""
    if device.type == "cuda" and x.device.type == "cpu":
        x = x.pin_memory()
    return x.to(device, non_blocking=True)
