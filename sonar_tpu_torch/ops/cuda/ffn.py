"""Fused int8 FFN: [LN ->] quant -> x@W1 -> +b1, ReLU -> requant -> @W2 -> +b2.

Port of ``sonar_tpu/ops/pallas/ffn.py`` (``fused_int8_ffn``,
``fused_int8_ffn_ln``, both through ``_fused_ffn_impl``); the CUDA kernel is
``csrc/ffn.cu``. Weight layout as ``quantize_params_int8`` makes it:
kernel_q [in, out] int8 stored column-major, scale [1, out] fp32.

Numerics kept from the TPU kernel: F is split into ``n_splits`` column
halves; the second quantisation has one scale per (row, split); each
split's output is rounded to x.dtype before the splits are summed, and b2
is added in x.dtype. The residual add is the caller's.
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda.int8_blocks import (
    check_cuda,
    f32,
    layer_norm_f32,
    quant_rows,
    require,
)
from sonar_tpu_torch.ops.quantization import int8_matmul
import torch

LAUNCHES = 0
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def fused_int8_ffn(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2, n_splits: int = 2):
    """relu(x@W1+b1)@W2 + b2 on x [M, D] (bf16/fp32) -> [M, D] in x.dtype."""
    return _fused_ffn_impl(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                           None, None, n_splits)


def fused_int8_ffn_ln(x, ln_scale, ln_bias, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                      n_splits: int = 2):
    """ffn(LN(x)) + b2: the pre-LN FFN branch without the residual add."""
    return _fused_ffn_impl(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                           ln_scale, ln_bias, n_splits)


def fused_ffn_plain(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                    ln_scale: Optional[torch.Tensor] = None,
                    ln_bias: Optional[torch.Tensor] = None,
                    n_splits: int = 2) -> torch.Tensor:
    x32 = x.float()
    if ln_scale is not None:
        x32 = layer_norm_f32(x32, ln_scale, ln_bias)
    x_q, x_scale = quant_rows(x32)
    fh = w1_q.shape[1] // n_splits
    out = None
    for s in range(n_splits):
        sl = slice(s * fh, (s + 1) * fh)
        h = (int8_matmul(x_q, w1_q[:, sl]).float() * x_scale
             * w1_scale[:, sl].float() + b1[None, sl].float())
        h_q, h_scale = quant_rows(torch.relu(h))
        part = (int8_matmul(h_q, w2_q[sl, :]).float() * h_scale
                * w2_scale.float()).to(x.dtype)
        out = part if out is None else out + part
    return out + b2[None, :].to(out.dtype)


def _fused_ffn_impl(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                    ln_scale, ln_bias, n_splits):
    if not x.is_cuda:
        return fused_ffn_plain(x, w1_q, w1_scale, b1, w2_q, w2_scale, b2,
                               ln_scale, ln_bias, n_splits)
    global LAUNCHES
    require(x.dim() == 2 and x.dtype in _KIND, "x must be [M, D] fp32 or bf16")
    m, d = x.shape
    f = w1_q.shape[-1]
    require(d % 128 == 0 and f % 128 == 0, f"D={d} and F={f} must be multiples of 128")
    require(f % n_splits == 0 and (f // n_splits) % 64 == 0,
            f"F={f} must split into {n_splits} multiples of 64")
    dev = x.device
    check_cuda("x", x, dev)
    check_cuda("w1_q", w1_q, dev, torch.int8, (d, f), col_major=True)
    check_cuda("w2_q", w2_q, dev, torch.int8, (f, d), col_major=True)
    params = [f32(t) for t in (ln_scale, ln_bias, w1_scale, b1, w2_scale, b2)]
    for name, t, n in zip(("ln_scale", "ln_bias", "w1_scale", "b1", "w2_scale", "b2"),
                          params, (d, d, f, f, d, d)):
        check_cuda(name, t, dev, torch.float32, (n,))
    ln_s, ln_b, s1, bias1, s2, bias2 = params
    x_q = torch.empty((m, d), dtype=torch.int8, device=dev)
    x_scale = torch.empty((m,), dtype=torch.float32, device=dev)
    h = torch.empty((m, f), dtype=torch.float32, device=dev)
    h_q = torch.empty((m, f), dtype=torch.int8, device=dev)
    h_scale = torch.empty((m, n_splits), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=x.dtype, device=dev)
    lib = _build.library()
    _build.check(
        lib.sonar_fused_int8_ffn(
            x.data_ptr(), _KIND[x.dtype], m, d, f, n_splits,
            _build.ptr(ln_s), _build.ptr(ln_b),
            w1_q.data_ptr(), s1.data_ptr(), bias1.data_ptr(),
            w2_q.data_ptr(), s2.data_ptr(), bias2.data_ptr(),
            x_q.data_ptr(), x_scale.data_ptr(), h.data_ptr(), h_q.data_ptr(),
            h_scale.data_ptr(), out.data_ptr(), _build.stream_of(x),
        ),
        "fused_int8_ffn",
    )
    LAUNCHES += 1
    return out
