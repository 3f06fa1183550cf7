"""Analytic matmul op counts for MFU accounting.

The port's copy of ``sonar_tpu.utils.flops``: the same counting functions,
with the peaks of the card the port runs on. They turn the three
north-star measurements (text encode, speech encode, beam decode) into
effective TFLOP/s or TOP/s against the model's *analytic* matmul op count.

Conventions:
- Counts are FLOPs (multiply-adds x2) of the MATMUL work only: projections,
  FFNs, attention score/PV contractions, vocab projection, depthwise conv.
  Elementwise work (LN, softmax, activations, rotaries) is bandwidth-bound
  and deliberately excluded: the number answers "what fraction of the
  tensor cores' peak is this workload sustaining".
- Counts use PADDED shapes: that is the work the device actually executes.
- Accuracy: exact for the dense projections/FFNs; attention terms assume
  full (unmasked-cost) S x S score/PV contractions. Small terms (pos-basis
  projections, pooler heads, biases) are omitted; the total is within a
  few percent.

Peaks: one NVIDIA H100 SXM at its full power limit of 700 W (NVIDIA's data
sheet, dense rates without sparsity): 989 TFLOP/s bf16 on the tensor
cores, 1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores. A card
set to a lower power limit (``nvidia-smi --query-gpu=name,power.limit``)
sustains less; ``mfu`` divides by the published peak all the same.
"""

from __future__ import annotations
H100_SXM_PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def mfu(effective_flops_per_sec: float, precision: str = "bf16") -> float:
    """Fraction of one H100 SXM's published peak sustained at ``precision``."""
    return effective_flops_per_sec / H100_SXM_PEAK[precision]


def transformer_encoder_flops(
    model_dim: int,
    ffn_inner_dim: int,
    num_layers: int,
    batch: int,
    seq_len: int,
) -> float:
    """Matmul FLOPs of one padded [batch, seq_len] encoder forward.

    Per layer: QKVO projections 8*D^2 per token, FFN 4*D*F per token,
    score + PV contractions 4*S*D per token.
    """
    d, f = model_dim, ffn_inner_dim
    per_token = num_layers * (8 * d * d + 4 * d * f)
    attn = num_layers * 4.0 * batch * seq_len * seq_len * d
    return batch * seq_len * float(per_token) + attn


def conformer_encoder_flops(
    model_dim: int,
    ffn_inner_dim: int,
    num_layers: int,
    depthwise_kernel_size: int,
    batch: int,
    seq_len: int,
) -> float:
    """Matmul FLOPs of one padded [batch, seq_len] Conformer forward.

    Per layer per token: macaron double FFN 8*D*F, MHSA projections 8*D^2,
    conv module 6*D^2 (pointwise GLU D->2D + pointwise D->D) + 2*k*D
    (depthwise); attention ac + bd + PV contractions ~6*S*D per token
    (rel-pos bd costs one more S-wide contraction than vanilla attention).
    """
    d, f, k = model_dim, ffn_inner_dim, depthwise_kernel_size
    per_token = num_layers * (8 * d * f + 8 * d * d + 6 * d * d + 2 * k * d)
    attn = num_layers * 6.0 * batch * seq_len * seq_len * d
    return batch * seq_len * float(per_token) + attn


def decoder_step_flops(
    model_dim: int,
    ffn_inner_dim: int,
    num_layers: int,
    vocab_size: int,
    rows: int,
    cache_len: float,
) -> float:
    """Matmul FLOPs of ONE incremental beam-decode step over ``rows``
    (= batch * beam) single-token rows against a ``cache_len``-deep KV cache.

    Per row: self-attn QKVO 8*D^2 + FFN 4*D*F per layer, score + PV against
    the cache 4*cache_len*D per layer, and the vocab projection 2*D*V.
    Cross-attention to the length-1 memory is not counted: its softmax
    over one key is 1, so its output does not change from step to step."""
    d, f = model_dim, ffn_inner_dim
    per_row = num_layers * (8 * d * d + 4 * d * f + 4 * cache_len * d)
    per_row += 2 * d * vocab_size
    return rows * float(per_row)
