"""Short-sequence self-attention on the fused QKV layout.

Port of ``sonar_tpu/ops/pallas/short_attn.py`` (``short_qkv_attention``);
the CUDA kernel is ``csrc/short_attn.cu``. qkv [B, S, 3 * H * Dh] (q | k | v
on the last axis), an additive fp32 key bias [B, S]; fp32 logits and
softmax, P rounded to the input dtype, P @ V in fp32; merged heads
[B, S, H * Dh] out.
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.attention import softmax
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

LAUNCHES = 0
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def short_qkv_attention_plain(
    qkv: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    b, s, three_d = qkv.shape
    d = three_d // 3
    dh = d // num_heads
    heads = [t.reshape(b, s, num_heads, dh).transpose(1, 2).float()
             for t in qkv.split(d, dim=-1)]
    q, k, v = heads
    logits = (q @ k.transpose(-1, -2)) * (dh ** -0.5)
    if bias is not None:
        logits = logits + bias.float()[:, None, None, :]
    p = softmax(logits).to(qkv.dtype).float()
    out = (p @ v).transpose(1, 2).reshape(b, s, d)
    return out.to(out_dtype or qkv.dtype)


def short_qkv_attention(
    qkv: torch.Tensor,                 # [B, S, 3*H*Dh]
    bias: Optional[torch.Tensor],      # [B, S] additive key bias
    num_heads: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Merged-head attention output [B, S, H*Dh] in ``out_dtype`` (default:
    the input dtype)."""
    if not qkv.is_cuda:
        return short_qkv_attention_plain(qkv, bias, num_heads, out_dtype)
    global LAUNCHES
    out_dtype = out_dtype or qkv.dtype
    require(qkv.dim() == 3 and qkv.shape[-1] % (3 * num_heads) == 0,
            f"qkv must be [B, S, 3*H*Dh], got {tuple(qkv.shape)}")
    b, s, three_d = qkv.shape
    d = three_d // 3
    dh = d // num_heads
    require(qkv.dtype in _KIND and out_dtype in _KIND, "fp32 and bf16 only")
    require(1 <= dh <= 128, f"head dim {dh} not in 1..128")
    check_cuda("qkv", qkv, qkv.device)
    if bias is not None:
        bias = bias.float().contiguous()
        check_cuda("bias", bias, qkv.device, torch.float32, (b, s))
    out = torch.empty((b, s, d), dtype=out_dtype, device=qkv.device)
    lib = _build.library()
    _build.check(
        lib.sonar_short_qkv_attention(
            qkv.data_ptr(), _build.ptr(bias), out.data_ptr(), b, s, num_heads, dh,
            _KIND[qkv.dtype], _KIND[out_dtype], _build.stream_of(qkv),
        ),
        "short_qkv_attention",
    )
    LAUNCHES += 1
    return out
