"""Bidirectional multi-layer LSTM, the LASER2 encoder's core
(``sonar_tpu.nn.lstm``).

The parameters keep torch's layout, as in the JAX package: per layer l and
direction d ('' or '_reverse'), ``weight_ih_l{l}{d}`` [4H, in],
``weight_hh_l{l}{d}`` [4H, H] and the biases [4H], gates in the order i, f,
g, o. No TPU kernel computes it: the port runs ``torch.nn.LSTM`` (cuDNN on
the card) over packed sequences, which processes each sequence over its own
length only, as the reference's packed run does.

One difference from the JAX scan, at padded positions only: the scan
freezes its state outside each sequence, so its forward outputs past a
sequence's end repeat the last valid ``h``; the packed run writes the
padding value there. The valid positions, and a max-pool that fills padded
positions with -inf (``LaserLstmEncoder``), agree.
"""

from __future__ import annotations

from typing import Any

from sonar_tpu_torch.nn.core import Params
import torch
from torch import nn


def build_lstm(params: Params, input_dim: int, hidden: int, num_layers: int,
               bidirectional: bool = True) -> nn.LSTM:
    """An ``nn.LSTM`` (no gradients, eval mode) holding ``params`` ({"l0":
    {"weight_ih", "weight_hh", "bias_ih", "bias_hh"}, "l0_reverse": ...});
    a missing bias is 0."""
    lstm = nn.LSTM(input_dim, hidden, num_layers=num_layers, bidirectional=bidirectional)
    directions = ("", "_reverse") if bidirectional else ("",)
    with torch.no_grad():
        for layer in range(num_layers):
            for d in directions:
                p = params[f"l{layer}{d}"]
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    dst = getattr(lstm, f"{name}_l{layer}{d}")
                    if name in p:
                        dst.copy_(torch.as_tensor(p[name]))
                    else:
                        dst.zero_()
    return lstm.requires_grad_(False).eval()


def bilstm_stack(lstm: nn.LSTM, x: torch.Tensor, seq_lens: Any,
                 padding_value: float = 0.0) -> torch.Tensor:
    """x [T, B, in], seq_lens [B] -> the last layer's outputs [T, B, H *
    directions]; positions at or past a sequence's length hold
    ``padding_value``. A sequence of length 0 runs over one position, whose
    output the caller masks."""
    t = x.shape[0]
    lens = torch.as_tensor(seq_lens).to("cpu", torch.int64).clamp(min=1)
    packed = nn.utils.rnn.pack_padded_sequence(x, lens, enforce_sorted=False)
    out, _ = lstm(packed)
    out, _ = nn.utils.rnn.pad_packed_sequence(out, total_length=t, padding_value=padding_value)
    return out
