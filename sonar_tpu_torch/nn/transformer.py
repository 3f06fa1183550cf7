"""Transformer encoder stack (encoder side of ``sonar_tpu.nn.transformer``).

Layer semantics of fairseq2's ``StandardTransformerEncoderLayer`` as SONAR
instantiates it: pre-LN (or post-LN) residual blocks, MHA with biased
q/k/v/output projections, FFN = inner_proj -> activation -> output_proj.

Parameters are nested dicts in the JAX layout; the per-layer tensors of a
stack carry a leading L axis, and ``encoder_stack`` loops over it.

The kernel gates are the JAX package's, on shapes and dtypes only; each
kernel wrapper then runs its plain version for CPU tensors and its CUDA
kernel for CUDA tensors. The thresholds (S 8..128, >= 2048 tokens) were
tuned on a TPU; re-tuning them on the H100 is open work.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from sonar_tpu_torch.nn.core import Params, get_activation, layer_norm, linear
from sonar_tpu_torch.ops.attention import dispatch_sdpa
import torch


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _key_bias(bias: Optional[torch.Tensor]) -> bool:
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


def mha(
    params: Params,
    x: torch.Tensor,
    kv: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
) -> torch.Tensor:
    if "qkv_proj" in params and x is kv:
        qkv = linear(params["qkv_proj"], x)
        if _key_bias(bias) and 8 <= qkv.shape[1] <= 128:
            # Short-sequence attention straight from the fused QKV layout.
            from sonar_tpu_torch.ops.cuda.short_attn import short_qkv_attention

            out = short_qkv_attention(
                qkv, None if bias is None else bias[:, 0, 0, :], num_heads
            )
            return linear(params["output_proj"], out)
        q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
        out = dispatch_sdpa(q, k, v, bias=bias)
        return linear(params["output_proj"], _merge_heads(out))
    q = _split_heads(linear(params["q_proj"], x), num_heads)
    k = _split_heads(linear(params["k_proj"], kv), num_heads)
    v = _split_heads(linear(params["v_proj"], kv), num_heads)
    out = dispatch_sdpa(q, k, v, bias=bias)
    return linear(params["output_proj"], _merge_heads(out))


def fuse_qkv(params: Params) -> Params:
    """Concatenate the q/k/v projections of every ``self_attn`` into one
    ``qkv_proj`` along the output axis (q | k | v), as a runtime copy."""

    def transform(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out: Dict[str, Any] = {}
        for key, value in node.items():
            if (
                key == "self_attn"
                and isinstance(value, dict)
                and {"q_proj", "k_proj", "v_proj"} <= set(value)
            ):
                names = ("q_proj", "k_proj", "v_proj")
                fused = dict(value)
                fused["qkv_proj"] = {
                    "kernel": torch.cat([value[p]["kernel"] for p in names], dim=-1)
                }
                if "bias" in value["q_proj"]:
                    fused["qkv_proj"]["bias"] = torch.cat(
                        [value[p]["bias"] for p in names], dim=-1
                    )
                out[key] = fused
            else:
                out[key] = transform(value)
        return out

    return transform(params)


def ffn(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    inner, out = params["inner_proj"], params["output_proj"]
    n_tokens = x.numel() // x.shape[-1]
    if (
        activation == "relu"
        and "kernel_q" in inner
        and "kernel_q" in out
        and "bias" in inner
        and "bias" in out
        and inner["kernel_q"].shape[1] % 256 == 0
        and inner["kernel_q"].shape[0] % 128 == 0
        and n_tokens >= 2048
    ):
        from sonar_tpu_torch.ops.cuda.ffn import fused_int8_ffn

        shape = x.shape
        y = fused_int8_ffn(
            x.reshape(-1, shape[-1]),
            inner["kernel_q"], inner["scale"], inner["bias"],
            out["kernel_q"], out["scale"], out["bias"],
        )
        return y.reshape(shape)
    act = get_activation(activation)
    return linear(out, act(linear(inner, x)))


def _residual_block(params_ln: Params, x: torch.Tensor, fn, norm_order: str) -> torch.Tensor:
    """PRE: x + fn(LN(x));  POST: LN(x + fn(x))."""
    if norm_order == "pre":
        return x + fn(layer_norm(params_ln, x))
    return layer_norm(params_ln, x + fn(x))


def _block_kernels_eligible(params: Params, x: torch.Tensor, bias, num_heads: int,
                            activation: str, norm_order: str) -> bool:
    """Whole-block kernels: pre-LN int8 layers with a fused QKV projection,
    ReLU FFN, key-padding bias, sentence-length sequences, enough tokens."""
    if norm_order != "pre" or activation != "relu" or not _key_bias(bias):
        return False
    sa, f = params["self_attn"], params["ffn"]
    if not ("qkv_proj" in sa and "kernel_q" in sa["qkv_proj"]
            and "kernel_q" in sa.get("output_proj", {})
            and "kernel_q" in f.get("inner_proj", {})
            and "kernel_q" in f.get("output_proj", {})):
        return False
    b, s, d = x.shape
    fdim = f["inner_proj"]["kernel_q"].shape[1]
    return 8 <= s <= 128 and d % 128 == 0 and fdim % 256 == 0 and b * s >= 2048


def encoder_layer(
    params: Params,
    x: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
) -> torch.Tensor:
    if _block_kernels_eligible(params, x, bias, num_heads, activation, norm_order):
        from sonar_tpu_torch.ops.cuda.attn_block import fused_attn_block
        from sonar_tpu_torch.ops.cuda.ffn import fused_int8_ffn_ln

        sa, f = params["self_attn"], params["ffn"]
        x = fused_attn_block(
            x,
            None if bias is None else bias[:, 0, 0, :],
            params["self_attn_layer_norm"]["weight"],
            params["self_attn_layer_norm"]["bias"],
            sa["qkv_proj"]["kernel_q"], sa["qkv_proj"]["scale"], sa["qkv_proj"]["bias"],
            sa["output_proj"]["kernel_q"], sa["output_proj"]["scale"],
            sa["output_proj"]["bias"],
            num_heads,
        )
        shape = x.shape
        y = fused_int8_ffn_ln(
            x.reshape(-1, shape[-1]),
            params["ffn_layer_norm"]["weight"],
            params["ffn_layer_norm"]["bias"],
            f["inner_proj"]["kernel_q"], f["inner_proj"]["scale"], f["inner_proj"]["bias"],
            f["output_proj"]["kernel_q"], f["output_proj"]["scale"], f["output_proj"]["bias"],
        )
        return x + y.reshape(shape)
    x = _residual_block(
        params["self_attn_layer_norm"], x,
        lambda h: mha(params["self_attn"], h, h, bias, num_heads), norm_order,
    )
    return _residual_block(
        params["ffn_layer_norm"], x,
        lambda h: ffn(params["ffn"], h, activation), norm_order,
    )


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in stacked.items()}


def num_stacked_layers(stacked: Params) -> int:
    node: Any = stacked
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node.shape[0]


def encoder_stack(
    stacked_params: Params,
    x: torch.Tensor,
    bias: Optional[torch.Tensor],
    num_heads: int,
    activation: str,
    norm_order: str = "pre",
) -> torch.Tensor:
    """Run the L stacked encoder layers in order."""
    for i in range(num_stacked_layers(stacked_params)):
        x = encoder_layer(layer_slice(stacked_params, i), x, bias, num_heads,
                          activation, norm_order)
    return x
