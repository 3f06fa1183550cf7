"""The speech encoder's weights (arch ``english``: the w2v-BERT Conformer and
its attention pooler) drawn from the seed on the device, in the type they
are served in, in the layout ``SonarSpeechEncoder`` takes (the JAX
package's: linear kernels [in, out], Conformer and pooler layers stacked on
a leading axis).

Distributions as ``weights.py``'s: Kaiming-uniform fan-in linears, drawn
LayerNorms (weight U(0.5, 1.5), bias U(-0.1, 0.1)). Everything the
identity initialisation would leave neutral is drawn too, so that a path
that skipped it would show: the BatchNorm's weight and running variance
U(0.5, 1.5), its bias and running mean U(-0.1, 0.1), ``u_bias`` and
``v_bias`` U(-0.5, 0.5), the depthwise kernel [K, 1, D] N(0, 1/K), every
row of the pooler's D-row table N(0, D^-0.5), ``r_proj`` and
``projection_out``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

from perfbench.harness.weights import _attn, _gen, _linear, _ln, _uniform


def _kernel(torch, g, n: Optional[int], din: int, dout: int, dtype, device) -> Dict[str, Any]:
    """An unbiased Kaiming-uniform linear, stacked over ``n`` layers (None:
    one)."""
    lead = () if n is None else (n,)
    return {"kernel": _uniform(torch, g, lead + (din, dout), math.sqrt(3.0 / din), dtype, device)}


def _range(torch, g, shape, lo: float, hi: float, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device).uniform_(lo, hi, generator=g)


def speech_encoder(torch: Any, cfg: dict, seed: int, dtype: Any, device: Any) -> Dict[str, Any]:
    """The ``english`` tree of ``cfg`` (the configuration's ``model``)."""
    g = _gen(torch, seed, device, 13)
    d, f, n = cfg["model_dim"], cfg["ffn_inner_dim"], cfg["num_encoder_layers"]
    h, k = cfg["num_encoder_attn_heads"], cfg["depthwise_kernel_size"]
    feat = cfg["num_fbank_channels"] * cfg["fbank_stride"]
    pn, pf = cfg["num_decoder_layers"], cfg["pooler_ffn_inner_dim"]

    def ffn():
        return {"inner_proj": _linear(torch, g, n, d, f, dtype, device),
                "output_proj": _linear(torch, g, n, f, d, dtype, device)}

    layers = {
        "ffn1_layer_norm": _ln(torch, g, (n, d), dtype, device),
        "ffn1": ffn(),
        "self_attn_layer_norm": _ln(torch, g, (n, d), dtype, device),
        "self_attn": {
            **_attn(torch, g, n, d, dtype, device),
            "sdpa": {"r_proj": _kernel(torch, g, n, d, d, dtype, device),
                     "u_bias": _uniform(torch, g, (n, h, d // h), 0.5, dtype, device),
                     "v_bias": _uniform(torch, g, (n, h, d // h), 0.5, dtype, device)},
        },
        "conv_layer_norm": _ln(torch, g, (n, d), dtype, device),
        "conv": {
            "pointwise_conv1": _kernel(torch, g, n, d, 2 * d, dtype, device),
            "depthwise_conv": {"kernel": torch.empty((n, k, 1, d), dtype=dtype, device=device)
                               .normal_(0.0, k ** -0.5, generator=g)},
            "batch_norm": {"weight": _range(torch, g, (n, d), 0.5, 1.5, dtype, device),
                           "bias": _uniform(torch, g, (n, d), 0.1, dtype, device),
                           "running_mean": _uniform(torch, g, (n, d), 0.1, dtype, device),
                           "running_var": _range(torch, g, (n, d), 0.5, 1.5, dtype, device)},
            "pointwise_conv2": _kernel(torch, g, n, d, d, dtype, device),
        },
        "ffn2_layer_norm": _ln(torch, g, (n, d), dtype, device),
        "ffn2": ffn(),
        "layer_norm": _ln(torch, g, (n, d), dtype, device),
    }
    pooler_layers = {
        "self_attn": _attn(torch, g, pn, d, dtype, device),
        "self_attn_layer_norm": _ln(torch, g, (pn, d), dtype, device),
        "encoder_decoder_attn": _attn(torch, g, pn, d, dtype, device),
        "encoder_decoder_attn_layer_norm": _ln(torch, g, (pn, d), dtype, device),
        "ffn": {"inner_proj": _linear(torch, g, pn, d, pf, dtype, device),
                "output_proj": _linear(torch, g, pn, pf, d, dtype, device)},
        "ffn_layer_norm": _ln(torch, g, (pn, d), dtype, device),
    }
    proj = _linear(torch, g, 1, feat, d, dtype, device)
    return {
        "encoder_frontend": {"post_extract_layer_norm": _ln(torch, g, (feat,), dtype, device),
                             "model_dim_proj": {"kernel": proj["kernel"][0],
                                                "bias": proj["bias"][0]}},
        "encoder": {"layers": layers},
        "layer_norm": _ln(torch, g, (d,), dtype, device),
        "encoder_pooler": {
            "decoder_frontend": {"embed": {"weight": torch.empty(
                (d, d), dtype=dtype, device=device).normal_(0.0, d ** -0.5, generator=g)}},
            "decoder": {"layers": pooler_layers},
            "projection_out": _kernel(torch, g, None, d, d, dtype, device),
        },
    }
