"""Int8 quantized inference (``sonar_tpu.ops.quantization``).

Per-output-channel symmetric int8 weights plus dynamic per-row activation
quantization. ``nn.core.linear`` dispatches here when a linear holds
``kernel_q``. Int8 products are exact int32: an fp32 matmul of int8 values
with K = 8192 passes 2^24 and is not.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Params = Dict[str, Any]

_QUANT_KEYS = (
    "q_proj", "k_proj", "v_proj", "qkv_proj", "output_proj",
    "inner_proj", "model_dim_proj", "projection_out",
    "pointwise_conv1", "pointwise_conv2",
)


def column_major(t: torch.Tensor) -> torch.Tensor:
    """``t`` [..., in, out] with each matrix stored column-major (its
    transpose contiguous): the layout of the int8 kernels in this package,
    which the CUDA GEMMs and ``torch._int_mm`` read without a copy."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_column_major(t: torch.Tensor) -> bool:
    return t.dim() >= 2 and t.transpose(-1, -2).is_contiguous()


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., in, out] float kernel -> (int8 kernel [..., in, out] stored
    column-major, fp32 scale [..., 1, out])."""
    w = kernel.float()
    scale = torch.clamp(w.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return column_major(q), scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 a [M, K] and int8 b [K, N].

    On CUDA this is the plain path outside any kernel: ``torch._int_mm``
    where its shape rules hold (M > 16, K and N multiples of 8), float64
    otherwise (exact: |sum| <= 127^2 * K < 2^53).
    """
    m, k = a.shape
    n = b.shape[1]
    if a.is_cuda:
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            # cuBLASLt's int8 GEMM takes a column-major b; the weights of
            # ``quantize_kernel`` already are, so for them this copies nothing.
            return torch._int_mm(a.contiguous(), column_major(b))
        return (a.double() @ b.double()).to(torch.int32)
    return torch._int_mm(a.contiguous(), b.contiguous())


def int8_linear(params: Params, x: torch.Tensor, group: Any = None) -> torch.Tensor:
    """Dynamic-activation int8 matmul: y = (x_q @ w_q) * (sx * sw) + b.

    As in the JAX version: the absmax reduces the input in its own dtype,
    and rounding multiplies by the reciprocal of the scale.

    ``group`` (a ``parallel.comm.Group``) marks a row-parallel projection:
    ``x`` is this rank's slice of the input axis. Each row's absmax is then
    the maximum over the group (a rank's slice alone would give another
    scale, another function), and the int32 products are summed over the
    group before they are scaled: the single-device result, exactly.
    """
    w_q = params["kernel_q"]          # [in, out] int8
    w_scale = params["scale"]         # [1, out] fp32
    absmax = x.abs().amax(dim=-1, keepdim=True).float()
    if group is not None:
        from sonar_tpu_torch.parallel.comm import all_max

        absmax = all_max(absmax, group)
    x_scale = torch.clamp(absmax / 127.0, min=1e-12)
    inv = 1.0 / x_scale
    x_q = torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)
    lead = x_q.shape[:-1]
    acc = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q).reshape(*lead, -1)
    if group is not None:
        from sonar_tpu_torch.parallel.comm import all_sum

        acc = all_sum(acc, group)
    y = acc.float() * x_scale * w_scale.reshape(w_scale.shape[-1])
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


def _transform_tree(node: Any, key: Any = None) -> Any:
    if not isinstance(node, dict):
        return node
    if key in _QUANT_KEYS and "kernel" in node:
        q, scale = quantize_kernel(node["kernel"])
        out = {k: v for k, v in node.items() if k != "kernel"}
        out["kernel_q"] = q
        out["scale"] = scale
        return out
    return {k: _transform_tree(v, k) for k, v in node.items()}


def quantize_params_int8(params: Params) -> Params:
    """Replace eligible Linear kernels with int8 + scales (a runtime copy).

    LayerNorms, embeddings and biases stay in floating point.
    """
    return _transform_tree(params)
