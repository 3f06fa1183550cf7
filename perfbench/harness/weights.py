"""Weights drawn from the seed on the device, in the type they are served in.

One ``torch.Generator`` on the run's device, one call per stacked leaf (a
leaf holds every layer), in the JAX package's parameter layout (linear
kernels [in, out], layers stacked on a leading axis) that the port's
models take. Distributions as the JAX ``init_params``: Kaiming-uniform
fan-in linears, an N(0, d^-0.5) embedding with a zero pad row; the
LayerNorms are drawn too (weight U(0.5, 1.5), bias U(-0.1, 0.1)), so that a
path that skipped one would show.

The harness keeps the tree and hands it to the program and, after the
window, to the plain reference.
"""

from __future__ import annotations

import math
from typing import Any, Dict


def _gen(torch: Any, seed: int, device: Any, stream: int) -> Any:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2**63))
    return g


def _uniform(torch, g, shape, bound, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(-bound, bound, generator=g)


def _linear(torch, g, n, din, dout, dtype, device) -> Dict[str, Any]:
    b = math.sqrt(1.0 / din)
    return {"kernel": _uniform(torch, g, (n, din, dout), math.sqrt(3.0) * b, dtype, device),
            "bias": _uniform(torch, g, (n, dout), b, dtype, device)}


def _ln(torch, g, shape, dtype, device) -> Dict[str, Any]:
    return {"weight": torch.empty(shape, dtype=dtype, device=device).uniform_(0.5, 1.5,
                                                                                generator=g),
            "bias": _uniform(torch, g, shape, 0.1, dtype, device)}


def _embedding(torch, g, rows, d, pad_idx, dtype, device):
    e = torch.empty((rows, d), dtype=dtype, device=device).normal_(0.0, d ** -0.5, generator=g)
    e[pad_idx] = 0
    return e


def _attn(torch, g, n, d, dtype, device):
    return {p: _linear(torch, g, n, d, d, dtype, device)
            for p in ("q_proj", "k_proj", "v_proj", "output_proj")}


def text_encoder(torch: Any, cfg: dict, seed: int, dtype: Any, device: Any) -> Dict[str, Any]:
    """A pre-LN ``basic``-style encoder: embedding, ``num_encoder_layers``
    self-attention + FFN layers, the final LayerNorm."""
    g = _gen(torch, seed, device, 11)
    d, f, n = cfg["model_dim"], cfg["ffn_inner_dim"], cfg["num_encoder_layers"]
    vi = cfg["vocab_info"]
    return {
        "encoder_frontend": {"embed": {"weight": _embedding(torch, g, vi["size"], d,
                                                            vi["pad_idx"], dtype, device)}},
        "encoder": {"layers": {
            "self_attn": _attn(torch, g, n, d, dtype, device),
            "self_attn_layer_norm": _ln(torch, g, (n, d), dtype, device),
            "ffn": {"inner_proj": _linear(torch, g, n, d, f, dtype, device),
                    "output_proj": _linear(torch, g, n, f, d, dtype, device)},
            "ffn_layer_norm": _ln(torch, g, (n, d), dtype, device),
        }},
        "layer_norm": _ln(torch, g, (d,), dtype, device),
    }


def text_decoder(torch: Any, cfg: dict, seed: int, dtype: Any, device: Any) -> Dict[str, Any]:
    """A pre-LN embedding-conditioned decoder: embedding (tied to the output
    projection), ``num_decoder_layers`` self-attention, cross-attention and
    FFN layers, the final LayerNorm."""
    g = _gen(torch, seed, device, 12)
    d, f, n = cfg["model_dim"], cfg["ffn_inner_dim"], cfg["num_decoder_layers"]
    vi = cfg["vocab_info"]
    return {
        "decoder_frontend": {"embed": {"weight": _embedding(torch, g, vi["size"], d,
                                                            vi["pad_idx"], dtype, device)}},
        "decoder": {
            "layers": {
                "self_attn": _attn(torch, g, n, d, dtype, device),
                "self_attn_layer_norm": _ln(torch, g, (n, d), dtype, device),
                "encoder_decoder_attn": _attn(torch, g, n, d, dtype, device),
                "encoder_decoder_attn_layer_norm": _ln(torch, g, (n, d), dtype, device),
                "ffn": {"inner_proj": _linear(torch, g, n, d, f, dtype, device),
                        "output_proj": _linear(torch, g, n, f, d, dtype, device)},
                "ffn_layer_norm": _ln(torch, g, (n, d), dtype, device),
            },
            "layer_norm": _ln(torch, g, (d,), dtype, device),
        },
    }
