"""The speech encoder's work: the least work of the rel-pos attention kernel
(#6, ``relpos_flash_attention_v2``) a launch, and the matmul work the
Conformer encoder needs for clips of given lengths. From shapes alone, so
that any later kernel that computes the same math is read against the same
work."""

from __future__ import annotations

from typing import Dict, Tuple

from perfbench.harness.roofline import bound_s


def relpos_work(b: int, h: int, s: int, dh: int, d: int) -> Tuple[float, Dict[str, float]]:
    """Rel-pos self-attention on q, k, v [b, h, s, dh] bf16 with a [b, s]
    fp32 key bias: the scores (q + u) k^T, the positional term (q + v) r^T
    against the projected [2s - 1, d] distance table, P V (6 b h s^2 dh),
    and the table's projection by r_proj, once a launch (2 (2s - 1) d^2).
    Bytes: q, k, v and the output once each, the [2s - 1, d] table, r_proj
    [d, d], u and v [h, dh], all bf16, and the key bias. The trig
    factorisation's bd over d (2 b h s^2 d) is the kernel's choice, not the
    math's, and is not counted."""
    moved = 2.0 * (4 * b * h * s * dh + (2 * s - 1) * d + d * d + 2 * h * dh) + 4.0 * b * s
    return moved, {"bf16": 6.0 * b * h * s * s * dh + 2.0 * (2 * s - 1) * d * d}


def relpos_least_s(b: int, h: int, s: int, dh: int, d: int) -> float:
    """The least time of one ``relpos_work`` launch on the card."""
    return bound_s(*relpos_work(b, h, s, dh, d))


def encoder_needed_flops(m: dict, clips: int, seq: int, seq_sq: int) -> float:
    """The bf16 matmul FLOPs of ``clips`` clips of true Conformer lengths
    summing to ``seq`` (and their squares to ``seq_sq``), for the
    configuration ``m``: a Conformer layer takes 8 n D F (the two half-FFNs),
    8 n D^2 (QKVO), 6 n D^2 (the pointwise convolutions), 2 K n D (the
    depthwise one), 6 n^2 D (scores, positional term, P V) and
    2 (2n - 1) D^2 (projecting the distance table); the frontend's
    projection 2 n (C x stride) D, and each pooler layer's K / V projection
    of the frames 4 n D^2."""
    d, f, k = m["model_dim"], m["ffn_inner_dim"], m["depthwise_kernel_size"]
    feat = m["num_fbank_channels"] * m["fbank_stride"]
    per_layer = ((8.0 * d * f + 14.0 * d * d + 2.0 * k * d + 4.0 * d * d) * seq
                 + 6.0 * d * seq_sq - 2.0 * d * d * clips)
    return (m["num_encoder_layers"] * per_layer + 2.0 * feat * d * seq
            + m["num_decoder_layers"] * 4.0 * d * d * seq)
