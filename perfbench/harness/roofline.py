"""The yardstick: the card's published peaks, the least time a piece of work
can take on it, and the matmul work of the models' passes.

Frozen copies, so that no later change to the program moves them:

- ``PEAK_OPS_S``, ``HBM_BYTES_S`` and ``bound`` of ``chip_smoke.py`` (one
  NVIDIA H100 SXM at its full 700 W, dense rates from NVIDIA's data sheet:
  989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor
  cores, 3.35 TB/s of HBM);
- ``decoder_step_flops`` of ``sonar_tpu_torch/utils/flops.py``;
- the kernels' operation and byte counts of ``chip_smoke.py`` (c), one
  function a kernel, from the shapes of a launch: each input byte read once
  and each output byte written once.

A share of a roofline is ``bound / measured``; a share above 1 means the
work was counted too high or the time misses part of it.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}


def bound_s(moved_bytes: float, ops: Dict[str, float]) -> float:
    """The larger of ``moved_bytes`` over HBM and ``ops`` ({type: count})
    over their peaks, in seconds."""
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops.items())
    return max(moved_bytes / HBM_BYTES_S, t_ops)


# -- kernels (a launch's shapes -> (bytes, {type: operations})) -----------------------


def int8_ffn_work(m: int, d: int, f: int) -> Tuple[float, Dict[str, float]]:
    """``fused_int8_ffn(_ln)`` on [m, d] bf16 rows: relu(x W1 + b1) W2 + b2
    with int8 weights W1 [d, f], W2 [f, d]; fp32 scales, biases and LN
    parameters."""
    moved = 2 * m * d * 2 + 2 * d * f + 4 * (f + d) * 2 + 2 * 4 * d
    return moved, {"int8": 4.0 * m * d * f}


def attn_block_work(b: int, s: int, d: int) -> Tuple[float, Dict[str, float]]:
    """``fused_attn_block`` on [b, s, d] bf16: LN, the fused int8 QKV
    projection, attention over all s keys, the int8 output projection and
    the residual; fp32 scales, biases and LN parameters, a b x s key bias."""
    m = b * s
    moved = 2 * m * d * 2 + 4 * d * d + 4 * (4 * d) * 2 + 2 * 4 * d + 4 * b * s
    return moved, {"int8": 8.0 * m * d * d, "bf16": 4.0 * b * s * s * d}


def flash_work(b: int, h: int, s: int, dh: int) -> Tuple[float, Dict[str, float]]:
    """``flash_attention`` on q, k, v [b, h, s, dh] bf16 with a key bias."""
    moved = 4 * b * h * s * dh * 2 + 4 * b * s
    return moved, {"bf16": 4.0 * b * h * s * s * dh}


# -- models ------------------------------------------------------------------------------


def encoder_needed_ops(lens: Iterable[int], d: int, f: int, layers: int
                       ) -> Dict[str, float]:
    """Matmul work an int8 encoder needs for sentences of the true lengths
    ``lens``: the int8 projections (QKVO 8 d^2, FFN 4 d f a token) and the
    bf16 attention contractions (4 L^2 d a sentence), a layer each."""
    lens = list(lens)
    tokens = float(sum(lens))
    return {"int8": layers * tokens * (8.0 * d * d + 4.0 * d * f),
            "bf16": layers * 4.0 * d * float(sum(n * n for n in lens))}


def decoder_step_flops(model_dim: int, ffn_inner_dim: int, num_layers: int, vocab_size: int,
                       rows: int, cache_len: float) -> float:
    """Matmul FLOPs of one incremental beam-decode step over ``rows``
    single-token rows against a ``cache_len``-deep cache: self-attention
    QKVO 8 D^2 and FFN 4 D F a layer, score and PV 4 cache_len D a layer,
    the vocabulary projection 2 D V; the cross-attention to the length-1
    memory is not counted (its output does not change from step to step)."""
    d, f = model_dim, ffn_inner_dim
    per_row = num_layers * (8 * d * d + 4 * d * f + 4 * cache_len * d)
    per_row += 2 * d * vocab_size
    return rows * float(per_row)


def decode_flops(steps: Sequence[int], rows: int, d: int, f: int, layers: int,
                 vocab: int) -> float:
    """FLOPs of decodes of ``steps[i]`` steps each (prefix steps included),
    step t (from 0) reading a cache of t + 1 positions."""
    return sum(decoder_step_flops(d, f, layers, vocab, rows, t + 1)
               for n in steps for t in range(n))
