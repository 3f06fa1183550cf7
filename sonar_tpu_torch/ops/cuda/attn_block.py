"""Pre-LN int8 self-attention residual block: x + O(attn(QKV(LN(x)))).

Port of ``sonar_tpu/ops/pallas/attn_block.py`` (``fused_attn_block``); the
CUDA kernel is ``csrc/attn_block.cu``. Quantisation points kept from the
TPU kernel: LN with fp32 statistics, per-row int8 quantisation (division by
the scale), QKV dequantised and rounded to bf16 even for an fp32 model, P
rounded to bf16, the attention output kept in fp32 into the requantisation,
and the residual added in fp32 before the cast to x.dtype.

The TPU kernel flattened several sequences into one row block with a
block-diagonal mask; attention here is per sequence. The two agree on every
sequence of length >= 1; a padding row of length 0 (all keys masked) gets a
uniform average of its own keys here and of other sequences' keys on the
TPU, and is discarded by both.

The attention step is ``csrc/attention.cuh``'s tensor-core core: one pass
over the keys up to S 128, past that the two-pass kernel that ``flash``
(#5) runs, on the fused QKV layout with fp32 output into merged heads.
Such a call counts one launch on ``flash.LAUNCHES`` besides its own, as a
profiler trace shows the two-pass kernel beside the block's GEMMs.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.cuda.int8_blocks import (
    check_cuda,
    f32,
    layer_norm_f32,
    quant_rows,
    require,
)
from sonar_tpu_torch.ops.cuda.short_attn import short_qkv_attention_plain
from sonar_tpu_torch.ops.quantization import int8_matmul
import torch

LAUNCHES = 0
# attention.cuh's TC_ONE_PASS_MAX, for the block gate, which runs without the
# library; a call counts #5's launch by the library's own value.
ONE_PASS_MAX = 128
_ONE_PASS_MAX_BUILT: Optional[int] = None
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def fused_attn_block_plain(x, bias, ln_scale, ln_bias, wqkv_q, sqkv, bqkv,
                           wo_q, so, bo, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    x32 = x.float().reshape(b * s, d)
    h_q, h_scale = quant_rows(layer_norm_f32(x32, ln_scale, ln_bias))
    qkv = (int8_matmul(h_q, wqkv_q).float() * h_scale
           * sqkv.float().reshape(1, -1) + bqkv.float()).to(torch.bfloat16)
    attn = short_qkv_attention_plain(qkv.reshape(b, s, 3 * d), bias, num_heads,
                                     out_dtype=torch.float32)
    a_q, a_scale = quant_rows(attn.reshape(b * s, d))
    out = (int8_matmul(a_q, wo_q).float() * a_scale
           * so.float().reshape(1, -1) + bo.float())
    return (x32 + out).to(x.dtype).reshape(b, s, d)


def fused_attn_block(
    x: torch.Tensor,                 # [B, S, D] bf16/fp32
    bias: Optional[torch.Tensor],    # [B, S] additive key-padding bias
    ln_scale: torch.Tensor,          # [D]
    ln_bias: torch.Tensor,           # [D]
    wqkv_q: torch.Tensor,            # [D, 3D] int8, column-major
    sqkv: torch.Tensor,              # [1, 3D]
    bqkv: torch.Tensor,              # [3D]
    wo_q: torch.Tensor,              # [D, D] int8, column-major
    so: torch.Tensor,                # [1, D]
    bo: torch.Tensor,                # [D]
    num_heads: int,
) -> torch.Tensor:
    if not x.is_cuda:
        return fused_attn_block_plain(x, bias, ln_scale, ln_bias, wqkv_q, sqkv,
                                      bqkv, wo_q, so, bo, num_heads)
    require(x.dim() == 3 and x.dtype in _KIND, "x must be [B, S, D] fp32 or bf16")
    b, s, d = x.shape
    dh = d // num_heads
    require(d % 128 == 0 and d % num_heads == 0 and dh <= 128,
            f"D={d} must be a multiple of 128 with head dim <= 128")
    dev = x.device
    check_cuda("x", x, dev)
    check_cuda("wqkv_q", wqkv_q, dev, torch.int8, (d, 3 * d), col_major=True)
    check_cuda("wo_q", wo_q, dev, torch.int8, (d, d), col_major=True)
    params = [f32(t) for t in (ln_scale, ln_bias, sqkv, bqkv, so, bo)]
    for name, t, n in zip(("ln_scale", "ln_bias", "sqkv", "bqkv", "so", "bo"),
                          params, (d, d, 3 * d, 3 * d, d, d)):
        check_cuda(name, t, dev, torch.float32, (n,))
    ln_s, ln_b, s_qkv, b_qkv, s_o, b_o = params
    if bias is not None:
        bias = bias.float().contiguous()
        check_cuda("bias", bias, dev, torch.float32, (b, s))
    m = b * s
    h_q = torch.empty((m, d), dtype=torch.int8, device=dev)
    h_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    attn = torch.empty((m, d), dtype=torch.float32, device=dev)
    a_q = torch.empty((m, d), dtype=torch.int8, device=dev)
    a_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    lib = _build.library()
    _build.check(
        lib.sonar_fused_attn_block(
            x.data_ptr(), _KIND[x.dtype], b, s, num_heads, dh, _build.ptr(bias),
            ln_s.data_ptr(), ln_b.data_ptr(), wqkv_q.data_ptr(), s_qkv.data_ptr(),
            b_qkv.data_ptr(), wo_q.data_ptr(), s_o.data_ptr(), b_o.data_ptr(),
            h_q.data_ptr(), h_scale.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
            a_q.data_ptr(), a_scale.data_ptr(), out.data_ptr(), _build.stream_of(x),
        ),
        "fused_attn_block",
    )
    launched("attn_block", "LAUNCHES")
    if s > one_pass_max():
        launched("flash", "LAUNCHES")
    return out


def one_pass_max() -> int:
    """The longest S whose attention step is the one-pass core, as the
    library was built (``TC_ONE_PASS_MAX``)."""
    global _ONE_PASS_MAX_BUILT
    if _ONE_PASS_MAX_BUILT is None:
        s_max = ctypes.c_int()
        _build.check(_build.library().sonar_attn_one_pass_max(ctypes.byref(s_max)),
                     "attn_one_pass_max")
        _ONE_PASS_MAX_BUILT = s_max.value
    return _ONE_PASS_MAX_BUILT
