"""Plain reference of the SONAR text encoder (``basic`` arch), fp32.

Written from the published architecture (fairseq2's NLLB encoder as SONAR
builds it): token embedding x sqrt(d) plus the fairseq sinusoidal position
table (half sin, half cos, frequencies exp(-i ln(10000) / (d/2 - 1)), read
from row t + pad_idx + 1); pre-LN layers, each x + attn(LN(x)) then
x + relu(LN(x) W1 + b1) W2 + b2, with 16 heads of softmax(q k^T / sqrt(dh))
v over the sentence's own tokens; a final LayerNorm (eps 1e-5); the mean
over the sentence's tokens, sum / (n + 1e-7).

``quant`` quantises every projection: ``"int8"`` as the int8 serving mode
states it (``"int4"`` is its control): weights symmetric per output
channel, activations symmetric per row, both by absmax / qmax (127, 7)
rounded to the nearest integer, the integer products summed exactly
(float64) and scaled back in fp32; ``"fp8"`` rounds weights (per output
channel) and activations (per row), each scaled to absmax 448, to
float8 e4m3 and multiplies the rounded values in fp32. The embedding and
the LayerNorms stay in fp32.

Plain PyTorch: fp32 with TF32 off, one sentence at a time (no padding),
layer by layer (a layer's weights made fp32 once for all sentences). It is
given the benchmark's weight tree and token ids, and imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch


def sinusoidal(rows: int, dim: int, device: Any) -> torch.Tensor:
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float64) * (-math.log(10000.0) / (half - 1)))
    args = torch.arange(rows, dtype=torch.float64)[:, None] * freq[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=1).float().to(device)


def layer_norm(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5) * p["weight"] + p["bias"]


QMAX = {"int8": 127, "int4": 7}


def _quant(t: torch.Tensor, qmax: int, dim: int):
    scale = torch.clamp(t.abs().amax(dim=dim, keepdim=True) / qmax, min=1e-12)
    return torch.clamp(torch.round(t / scale), -qmax, qmax), scale


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = torch.clamp(t.abs().amax(dim=dim, keepdim=True) / 448.0, min=1e-12)
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x @ p["kernel"] + p["bias"]
    if quant == "fp8":
        if "_q" not in p:  # the weight's rounded values, once a layer
            p["_q"] = _fp8(p["kernel"], 0)
        return _fp8(x, -1) @ p["_q"] + p["bias"]
    if "_q" not in p:  # the weight's integers and scales, once a layer
        p["_q"] = _quant(p["kernel"], QMAX[quant], 0)
    wq, ws = p["_q"]
    xq, xs = _quant(x, QMAX[quant], -1)
    return (xq.double() @ wq.double()).float() * xs * ws + p["bias"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              causal: bool = False) -> torch.Tensor:
    """[n, d] queries against [m, d] keys and values."""
    n, d = q.shape
    dh = d // heads
    qh = q.reshape(n, heads, dh).transpose(0, 1)
    kh = k.reshape(-1, heads, dh).transpose(0, 1)
    vh = v.reshape(-1, heads, dh).transpose(0, 1)
    s = qh @ kh.transpose(1, 2) / math.sqrt(dh)
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return (torch.softmax(s, dim=-1) @ vh).transpose(0, 1).reshape(n, d)


def _fp32(tree: Any, index: Optional[int] = None) -> Any:
    if isinstance(tree, dict):
        return {k: _fp32(v, index) for k, v in tree.items()}
    return (tree if index is None else tree[index]).float()


class precise:
    """fp32 matmuls without TF32 inside the block."""

    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags


def embed(tree: Dict[str, Any], cfg: dict, ids: Sequence[Sequence[int]],
          quant: Optional[str] = "int8") -> torch.Tensor:
    """[len(ids), d] fp32 sentence embeddings of the token-id lists."""
    emb = tree["encoder_frontend"]["embed"]["weight"]
    dev = emb.device
    d, heads = cfg["model_dim"], cfg["num_encoder_attn_heads"]
    offset = cfg["vocab_info"]["pad_idx"] + 1
    pe = sinusoidal(cfg["max_seq_len"] + offset, d, dev)
    with precise(), torch.no_grad():
        xs: List[torch.Tensor] = []
        for seq in ids:
            t = torch.tensor(list(seq), dtype=torch.long, device=dev)
            xs.append(emb[t].float() * math.sqrt(d) + pe[offset:offset + len(seq)])
        layers = tree["encoder"]["layers"]
        for i in range(cfg["num_encoder_layers"]):
            p = _fp32(layers, i)
            sa, ffn = p["self_attn"], p["ffn"]
            for j, x in enumerate(xs):
                h = layer_norm(x, p["self_attn_layer_norm"])
                a = attention(linear(h, sa["q_proj"], quant), linear(h, sa["k_proj"], quant),
                              linear(h, sa["v_proj"], quant), heads)
                x = x + linear(a, sa["output_proj"], quant)
                h = layer_norm(x, p["ffn_layer_norm"])
                h = torch.relu(linear(h, ffn["inner_proj"], quant))
                xs[j] = x + linear(h, ffn["output_proj"], quant)
        final = _fp32(tree["layer_norm"])
        return torch.stack([layer_norm(x, final).sum(0) / (x.shape[0] + 1e-7) for x in xs])
