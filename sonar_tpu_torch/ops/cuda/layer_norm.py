"""Residual add + LayerNorm in one launch: ``add_layer_norm``, the CUDA
kernel of ``csrc/add_layer_norm.cu``.

x_out = x + res_scale * branch and ln = LayerNorm(x_out), on rows of D. It
replaces no Pallas kernel: the JAX Conformer block
(``sonar_tpu/nn/conformer.py`` ``conformer_block``) writes each residual
add and the LayerNorm after it as plain jnp (``sonar_tpu/nn/core.py``
``layer_norm``), which XLA fuses on the TPU; eager PyTorch runs them as
about a dozen row-wide kernels (casts, two means, the subtractions, the
square, the products, the bias). Bound: bytes over 3.35 TB/s, 4 D
sizeof(T) a row with a branch and ``x_out``, 3 without ``x_out``, 2
without a branch; the design touches each byte once (one warp a row, the
row held in registers, the statistics by warp shuffles).

Numerics: the eager path's roundings step by step, no contraction:
T(res_scale * branch), then x_out = T(x + that), bit-identical to
``x + 0.5 * f`` in T; the LayerNorm rounds where ``nn.core.layer_norm``
does, and differs from it only by the order of its fp32 sums.

The kernel takes x of ``_KIND`` (bf16, fp32) with D a multiple of 256 up
to 2048 (``kernel_takes``), and LayerNorm parameters stored in fp32 or in
x's dtype, read as they are (no cast per call). For a CPU tensor the
wrapper runs ``add_layer_norm_plain``; for a CUDA tensor it launches the
kernel or raises. ``LAUNCHES`` counts its launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

from sonar_tpu_torch.nn.core import Params, layer_norm
from sonar_tpu_torch.ops import _build
from sonar_tpu_torch.ops.cuda import launched
from sonar_tpu_torch.ops.cuda.int8_blocks import check_cuda, require
import torch

LAUNCHES = 0
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def kernel_takes(x: torch.Tensor, ln_params: Params) -> bool:
    """True when the kernel takes rows like ``x``'s with these LayerNorm
    parameters: x bf16 or fp32 with D a multiple of 256 up to 2048, the
    weight and bias both in fp32 or both in x's dtype."""
    d, w, b = x.shape[-1], ln_params["weight"], ln_params["bias"]
    return (x.dtype in _KIND and d % 256 == 0 and 256 <= d <= 2048
            and w.dtype == b.dtype and w.dtype in (torch.float32, x.dtype))


def add_layer_norm_plain(x: torch.Tensor, branch: Optional[torch.Tensor], ln_params: Params,
                         res_scale: float = 1.0,
                         want_sum: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The eager composition: x + res_scale * branch (x + branch at 1.0; x
    when there is no branch), then ``nn.core.layer_norm``."""
    if branch is not None:
        x = x + branch if res_scale == 1.0 else x + res_scale * branch
    return (x if want_sum else None), layer_norm(ln_params, x)


def add_layer_norm(x: torch.Tensor, branch: Optional[torch.Tensor], ln_params: Params,
                   res_scale: float = 1.0,
                   want_sum: bool = True) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """-> (x_out, ln) on x [..., D] (branch None or x's shape and dtype):
    x_out = x + res_scale * branch (None unless ``want_sum``; x itself when
    there is no branch), ln = LayerNorm(x_out) with ``ln_params``' weight
    and bias, both in x.dtype."""
    if not x.is_cuda:
        return add_layer_norm_plain(x, branch, ln_params, res_scale, want_sum)
    d, w, b = x.shape[-1], ln_params["weight"], ln_params["bias"]
    require(kernel_takes(x, ln_params),
            f"x must be fp32 or bf16 with D a multiple of 256 up to 2048 and the LayerNorm "
            f"parameters both fp32 or of x's dtype; got x {x.dtype}, D={d}, {w.dtype}, {b.dtype}")
    dev = x.device
    check_cuda("x", x, dev)
    check_cuda("branch", branch, dev, x.dtype, x.shape)
    check_cuda("weight", w, dev, shape=(d,))
    check_cuda("bias", b, dev, shape=(d,))
    rows = x.numel() // d
    ln = torch.empty_like(x)
    if branch is None:
        x_out = x if want_sum else None
    else:
        x_out = torch.empty_like(x) if want_sum else None
    if rows == 0:
        return x_out, ln
    _build.check(
        _build.library().sonar_add_layer_norm(
            x.data_ptr(), _build.ptr(branch), _KIND[x.dtype], rows, d, float(res_scale),
            w.data_ptr(), b.data_ptr(), _KIND[w.dtype],
            None if branch is None else _build.ptr(x_out), ln.data_ptr(), _build.stream_of(x),
        ),
        "add_layer_norm",
    )
    launched("layer_norm", "LAUNCHES")
    return x_out, ln
