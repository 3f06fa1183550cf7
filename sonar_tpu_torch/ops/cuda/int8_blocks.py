"""Plain PyTorch versions of the int8 building blocks in ``csrc/int8_gemm.cuh``
(shared by the FFN and attention-block kernels), and the wrapper-side checks
both kernels make.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sonar_tpu_torch.ops.quantization import is_column_major


def layer_norm_f32(x32: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm of an fp32 tensor with fp32 affine parameters (eps 1e-5)."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + 1e-5) * weight.float() + bias.float()


def quant_rows(x32: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantisation as the TPU kernels do it: round(x / scale)."""
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def check_cuda(name: str, t: Optional[torch.Tensor], device: torch.device,
               dtype: Optional[torch.dtype] = None, shape: Optional[tuple] = None,
               col_major: bool = False) -> None:
    """Raise unless ``t`` is a tensor on ``device`` of the given dtype and
    shape (None skips a check), contiguous, or stored column-major with
    ``col_major`` (the int8 weights of ``quantize_kernel``)."""
    if t is None:
        return
    require(t.device == device, f"{name} must be on {device}, got {t.device}")
    require(dtype is None or t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    require(shape is None or tuple(t.shape) == tuple(shape),
            f"{name} must have shape {tuple(shape or ())}, got {tuple(t.shape)}")
    if col_major:
        require(is_column_major(t), f"{name} must be stored column-major (quantize_kernel)")
    else:
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")


def f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A contiguous fp32 copy of a small parameter vector (None passes)."""
    return None if t is None else t.float().contiguous().reshape(-1)
