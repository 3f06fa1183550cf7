"""The work an NLLB-MoE translation needs, from the model's widths and what a
run counted: the matrix FLOPs of a batch's encoder and decoder passes, the
least bytes a decode step reads, and the least time of the expert GEMMs of
one sparse layer's call. Frozen with the benchmark, so that no change to
the program moves them.

Counts are of what the inputs need: true source lengths, the held experts'
routed rows (the program's counters), each weight read once a step, the
self cache at one row a position a sentence (a sentence's beams may share
every position), the source K/V once a sentence; so that no share of a
roofline computed from them can exceed 100%.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from perfbench.harness.roofline import HBM_BYTES_S, PEAK_OPS_S

BF16 = 2


def _dims(m: dict):
    return m["model_dim"], m["ffn_inner_dim"], m["router_experts"]


def sparse_layers(n_layers: int, step: int) -> int:
    return n_layers // step if step > 0 else 0


def encoder_flops(m: dict, source_lens: Sequence[int], expert_rows: int) -> float:
    """The encoder over sentences of ``source_lens`` tokens: per layer the
    four projections (8 n d^2) and attention (4 n^2 d); the dense FFN (4 n d
    f) in the dense layers; in the sparse ones the router (2 n d E) and the
    held experts' ``expert_rows`` routed rows (4 d f each)."""
    d, f, e = _dims(m)
    layers = m["num_encoder_layers"]
    sparse = sparse_layers(layers, m["encoder_sparse_step"])
    n = float(sum(source_lens))
    n2 = float(sum(x * x for x in source_lens))
    return (layers * (8 * n * d * d + 4 * n2 * d) + (layers - sparse) * 4 * n * d * f
            + sparse * 2 * n * d * e + 4.0 * expert_rows * d * f)


def decoder_flops(m: dict, batches: List[Dict], beam: int, prefix_len: int,
                  expert_rows: int) -> float:
    """The decoder steps the device ran: each batch's ``sentences`` x
    ``beam`` rows for its ``steps`` (the prefix's included), each row per
    layer self-attention's projections (8 d^2) and scores over the cache
    up to its position (4 pos d), cross-attention's q and output (4 d^2) and
    scores over the true source (4 src d), the dense FFN (4 d f) or the
    router (2 d E); the held experts' routed rows (4 d f each); the tied
    projection (2 d V); and once a sentence the source's K/V (4 src d^2 a
    layer)."""
    d, f, e = _dims(m)
    layers = m["num_decoder_layers"]
    sparse = sparse_layers(layers, m["decoder_sparse_step"])
    v = m["vocab_info"]["size"]
    total = 4.0 * expert_rows * d * f
    for b in batches:
        rows, steps = b["sentences"] * beam, b["steps"]
        src = float(sum(b["source_lens"]))
        positions = steps * (steps + 1) / 2.0  # cache lengths 1..steps
        per_row = layers * (12 * d * d) + (layers - sparse) * 4 * d * f + sparse * 2 * d * e \
            + 2 * d * v
        total += rows * steps * per_row + layers * 4 * d * rows * positions
        total += layers * 4 * d * beam * src * steps + layers * 4 * src * d * d
    return total


def step_weight_bytes(m: dict, hits_per_sparse_layer: float) -> float:
    """The decoder weights one step reads once: every layer's self-attention
    (4 d^2) and cross-attention's q and output (2 d^2) with biases, the dense
    FFNs, the routers, ``hits_per_sparse_layer`` held experts in each sparse
    layer (those that got a row), the final LayerNorm, and the tied table."""
    d, f, e = _dims(m)
    layers = m["num_decoder_layers"]
    sparse = sparse_layers(layers, m["decoder_sparse_step"])
    attn = 6 * d * d + 6 * d + 6 * d
    ffn = 2 * d * f + f + d
    params = layers * attn + (layers - sparse) * ffn + sparse * (d * e + hits_per_sparse_layer
                                                                 * ffn)
    return BF16 * (params + 2 * d + m["vocab_info"]["size"] * d)


def loop_bytes(m: dict, batches: List[Dict], prefix_len: int, hits_per_sparse_layer: float
               ) -> float:
    """The least bytes the search's loop reads over every batch's loop steps
    (its steps less the prefix's, which the setup runs): the weights once a
    step, the self cache at one row a position a sentence up to the step's
    position, and the source K/V of the true lengths."""
    d = m["model_dim"]
    layers = m["num_decoder_layers"]
    w = step_weight_bytes(m, hits_per_sparse_layer)
    total = 0.0
    for b in batches:
        loop_steps = b["steps"] - prefix_len
        if loop_steps <= 0:
            continue
        # positions prefix_len + 1 .. prefix_len + loop_steps
        positions = loop_steps * prefix_len + loop_steps * (loop_steps + 1) / 2.0
        cache = BF16 * 2 * layers * d * b["sentences"] * positions
        src = BF16 * 2 * layers * d * float(sum(b["source_lens"])) * loop_steps
        total += loop_steps * w + cache + src
    return total


def experts_least_s(m: dict, group_rows: Sequence[int]) -> float:
    """The least time of one call's two expert GEMMs: the weights of the held
    experts that got a row and the routed rows in and out at 3.35 TB/s, or
    their FLOPs (4 rows d f) at 989 TFLOP/s, the larger."""
    d, f, _ = _dims(m)
    rows = float(sum(group_rows))
    hit = sum(1 for r in group_rows if r > 0)
    moved = BF16 * (hit * (2 * d * f + f + d) + 2 * rows * d)
    return max(moved / HBM_BYTES_S, 4.0 * rows * d * f / PEAK_OPS_S["bf16"])
