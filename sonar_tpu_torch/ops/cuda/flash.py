"""Fused attention over [B, H, S, Dh] for SONAR-length sequences.

Port of ``sonar_tpu/ops/pallas/flash.py`` (``pallas_flash_attention``); the
CUDA kernel is ``csrc/flash.cu``. The bias is head-independent: key padding
[B, 1, 1, Skv] or full [B, 1, Sq, Skv]. Softmax in fp32, P normalised and
then rounded to the value dtype (as the TPU kernel does), P @ V in fp32.
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.attention import softmax
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

LAUNCHES = 0
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    logits = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if bias is not None:
        logits = logits + bias.float()
    p = softmax(logits).to(v.dtype).float()
    return (p @ v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q [B, H, Sq, Dh], k/v [B, H, Skv, Dh] (any strides with a unit last
    stride); bias [B, 1, 1, Skv] or [B, 1, Sq, Skv]. -> [B, H, Sq, Dh]."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bias)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be 4-D")
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    require(tuple(k.shape) == (b, h, skv, dh) and tuple(v.shape) == (b, h, skv, dh),
            f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match q {tuple(q.shape)}")
    require(q.dtype in _KIND and k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k, v must share one dtype, fp32 or bf16")
    require(dh in (64, 128), f"head dim {dh} not in (64, 128)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        require(t.device == q.device, f"{name} must be on {q.device}")
        require(t.stride(-1) == 1, f"{name} must have a unit last stride")
    mode = 0
    if bias is not None:
        require(bias.dim() == 4 and bias.shape[0] == b and bias.shape[1] == 1
                and bias.shape[-1] == skv and bias.shape[2] in (1, sq),
                f"bias must be [B, 1, 1, Skv] or [B, 1, Sq, Skv], got {tuple(bias.shape)}")
        mode = 1 if bias.shape[2] == 1 else 2
        bias = bias.float().contiguous()
        check_cuda("bias", bias, q.device)
    out = torch.empty((b, h, sq, dh), dtype=q.dtype, device=q.device)
    lib = _build.library()
    _build.check(
        lib.sonar_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(bias), mode,
            out.data_ptr(), b, h, sq, skv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            _KIND[q.dtype], _build.stream_of(q),
        ),
        "flash_attention",
    )
    launched("flash", "LAUNCHES")
    return out
