"""Scaled dot-product attention (``sonar_tpu.ops.attention``).

``sdpa`` is the plain formulation (fp32 logits and softmax, output in the
input dtype). ``dispatch_sdpa`` sends long-sequence encoder self-attention
to the fused kernel under the JAX package's gate; the gate looks at shapes
and at the caller's choice (``set_attention_impl``, the ``no_cuda_kernels()``
scope) and takes the plain version whenever autograd records
(``ops.gates``), and the kernel wrapper decides by device (plain version on
CPU, CUDA kernel on the card). Layout [B, H, S, Dh].
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.ops.gates import attention_impl, kernels_allowed
from sonar_tpu_torch.ops.gates import set_attention_impl as set_attention_impl
import torch

# Below this length the [S, S] logits are cheap. Tuned on a TPU and kept as
# the JAX package has it; re-tuning on the H100 is open work.
_FLASH_MIN_SEQ = 256


def softmax(logits: torch.Tensor) -> torch.Tensor:
    """exp(l - max) / sum over the last axis, with a true division (as
    ``jax.nn.softmax`` and the TPU kernels compute it)."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """[B, H, Sq, Dh] x [B, H, Skv, Dh] -> [B, H, Sq, Dh].

    ``bias`` is an additive fp32 bias broadcastable to [B, H, Sq, Skv].
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    probs = softmax(logits)
    return (probs.to(q.dtype).float() @ v.float()).to(q.dtype)


def dispatch_sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused kernel handles full self-attention with a head-independent
    bias (key padding from S >= 256, a full bias from S >= 128; any S under
    ``set_attention_impl("cuda")``) and head dim 64 or 128, outside autograd
    and ``no_cuda_kernels()``; everything else, and everything under
    ``set_attention_impl("plain")``, takes ``sdpa``."""
    impl = attention_impl()
    head_independent = bias is None or (bias.dim() == 4 and bias.shape[1] == 1)
    full_bias = bias is not None and bias.dim() == 4 and bias.shape[-2] != 1
    min_seq = 1 if impl == "cuda" else (128 if full_bias else _FLASH_MIN_SEQ)
    eligible = (
        impl != "plain"
        and q.shape[-2] == k.shape[-2]
        and q.shape[-2] >= min_seq
        and head_independent
        and q.shape[-1] in (64, 128)
        and kernels_allowed(q, k, v, bias)
    )
    if eligible:
        from sonar_tpu_torch.ops.cuda.flash import flash_attention

        return flash_attention(q, k, v, bias=bias)
    return sdpa(q, k, v, bias=bias)
