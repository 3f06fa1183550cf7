"""Plain reference of NLLB-200 MoE (``facebook/nllb-moe-54b``), fp32.

Written from the published description (arXiv:2207.04672; HF's
``NllbMoeConfig`` and the layer equations of HF's ``NllbMoe`` and fairseq's
``moe_freq 4`` transformer):

- one embedding table, scaled by sqrt(d), shared by the encoder and the
  decoder and tied to the output projection; the fairseq sinusoidal table
  (half sin, half cos, frequencies exp(-i ln(10000) / (d/2 - 1))) read from
  row t + pad_idx + 1;
- pre-LN layers (LayerNorm eps 1e-5): x + attn(LN(x)); in the decoder, x +
  cross_attn(LN(x), memory); x + ffn(LN(x)); a final LayerNorm a stack;
- the FFN relu(x W1 + b1) W2 + b2, or in layer i with (i + 1) % sparse_step
  == 0 the expert layer: the router's logits x R (no bias, fp32), their
  softmax, top-1 its argmax, top-2 the argmax of the logits with top-1
  masked, the two probabilities divided by their sum; each token's output
  sum_j gate_j * expert_j(x), every expert an FFN of the dense shape, no
  token dropped (capacity = the batch's tokens at inference);
- logits against the table, log-softmax over the whole vocabulary.

The one departure: the experts are cut to those the benchmark's tree holds
(``num_experts`` from ``experts_first``, of the router's 128), whose outputs are
the only ones added; an uncut tree (every expert held) gives the whole
layer. HF's eval path scales the expert outputs by 1 - ``moe_token_dropout``
(0.8); fairseq masks experts' outputs (EOM) only in training, and this
reference, as the program, follows fairseq.

Plain PyTorch: fp32 with TF32 off, one sentence and one hypothesis at a
time (no padding, no cache), layer by layer (a layer's weights made fp32
once for all of them, so a 54B tree upcasts one layer at a time). It is
given the benchmark's weight tree and token ids and imports nothing of the
program. ``quant``: ``"bf16"`` rounds every projection's input and weight
to bf16 (the program's precision, for the share of routing decisions it
flips); ``"fp8"`` rounds them to e4m3 (input per row, weight per output
channel), the control. The router stays fp32 in every mode, as published.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from perfbench.reference.text_decoder import (  # noqa: F401 (beam checks of predict_translate)
    candidate_gaps,
    hypothesis_score,
    kept_gaps,
)
from perfbench.reference.text_encoder import _fp8, attention, layer_norm, precise, sinusoidal
import torch


def _weights(tree: Any, index: int) -> Any:
    """Layer ``index`` of a stacked group in fp32 (integer leaves left out)."""
    if isinstance(tree, dict):
        return {k: _weights(v, index) for k, v in tree.items()
                if isinstance(v, dict) or v.is_floating_point()}
    return tree[index].float()


def linear(x: torch.Tensor, p: Dict[str, torch.Tensor], quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x @ p["kernel"] + p["bias"]
    if quant == "bf16":
        if "_q" not in p:
            p["_q"] = p["kernel"].bfloat16().float()
        return x.bfloat16().float() @ p["_q"] + p["bias"]
    if quant == "fp8":
        if "_q" not in p:
            p["_q"] = _fp8(p["kernel"], 0)
        return _fp8(x, -1) @ p["_q"] + p["bias"]
    raise ValueError(f"unknown precision {quant!r}")


def held_range(cfg: dict) -> Tuple[int, int]:
    """[first, end) of the experts the tree holds: ``num_experts`` of the
    router's ``router_experts``, from ``experts_first``."""
    return cfg["experts_first"], cfg["experts_first"] + cfg["num_experts"]


def route(x: torch.Tensor, router: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [n, d] -> (experts [n, 2], gates [n, 2]) of the fp32 router."""
    logits = x @ router
    probs = torch.softmax(logits, dim=-1)
    first = probs.argmax(dim=-1)
    second = logits.scatter(-1, first[:, None], float("-inf")).argmax(dim=-1)
    experts = torch.stack([first, second], dim=-1)
    p = probs.gather(-1, experts)
    return experts, p / p.sum(dim=-1, keepdim=True)


def experts_ffn(x: torch.Tensor, p: Dict[str, Any], held: Tuple[int, int],
                quant: Optional[str], log: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The expert layer's output for x [n, d] (already layer-normed), the
    held experts' part; ``log`` gets each token's top-2."""
    experts, gates = route(x, p["router"]["kernel"])
    if log is not None:
        log.append(experts.cpu())
    out = torch.zeros_like(x)
    inner, outer = p["inner_proj"], p["output_proj"]
    split = p.setdefault("_experts", {})  # each expert's weights, once a layer
    for e in range(held[0], held[1]):
        hit = experts == e                                   # [n, 2]
        rows = hit.any(dim=-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        s = e - held[0]
        if s not in split:
            split[s] = ({"kernel": inner["kernel"][s], "bias": inner["bias"][s]},
                        {"kernel": outer["kernel"][s], "bias": outer["bias"][s]})
        w1, w2 = split[s]
        y = linear(torch.relu(linear(x[rows], w1, quant)), w2, quant)
        out[rows] += (gates[rows] * hit[rows]).sum(dim=-1, keepdim=True) * y
    return out


def _plan(n: int, step: int) -> List[Tuple[bool, int]]:
    out, counts = [], [0, 0]
    for i in range(n):
        sparse = step > 0 and (i + 1) % step == 0
        out.append((sparse, counts[sparse]))
        counts[sparse] += 1
    return out


def _ffn(x: torch.Tensor, p: Dict[str, Any], sparse: bool, held: Tuple[int, int],
         quant: Optional[str], log: Optional[List[torch.Tensor]]) -> torch.Tensor:
    h = layer_norm(x, p["ffn_layer_norm"])
    if sparse:
        return x + experts_ffn(h, p["ffn"], held, quant, log)
    f = p["ffn"]
    return x + linear(torch.relu(linear(h, f["inner_proj"], quant)), f["output_proj"], quant)


def _embed(tree: dict, cfg: dict, ids: Sequence[int], pe: torch.Tensor) -> torch.Tensor:
    emb = tree["embed"]["weight"]
    t = torch.tensor(list(ids), dtype=torch.long, device=emb.device)
    offset = cfg["vocab_info"]["pad_idx"] + 1
    return emb[t].float() * math.sqrt(cfg["model_dim"]) + pe[offset:offset + len(ids)]


def _table(cfg: dict, device: Any) -> torch.Tensor:
    return sinusoidal(cfg["max_seq_len"] + cfg["vocab_info"]["pad_idx"] + 1, cfg["model_dim"],
                      device)


def encode(tree: dict, cfg: dict, sources: Sequence[Sequence[int]], quant: Optional[str] = None,
           routes: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """[len(src), d] fp32 memory of each source id list; ``routes`` gets
    every sparse layer's top-2 of every token, sentence by sentence."""
    dev = tree["embed"]["weight"].device
    heads, held = cfg["num_encoder_attn_heads"], held_range(cfg)
    pe = _table(cfg, dev)
    with precise(), torch.no_grad():
        xs = [_embed(tree, cfg, src, pe) for src in sources]
        stack = tree["encoder"]
        for sparse, i in _plan(cfg["num_encoder_layers"], cfg["encoder_sparse_step"]):
            p = _weights(stack["sparse_layers" if sparse else "layers"], i)
            sa = p["self_attn"]
            for j, x in enumerate(xs):
                h = layer_norm(x, p["self_attn_layer_norm"])
                a = attention(linear(h, sa["q_proj"], quant), linear(h, sa["k_proj"], quant),
                              linear(h, sa["v_proj"], quant), heads)
                x = x + linear(a, sa["output_proj"], quant)
                xs[j] = _ffn(x, p, sparse, held, quant, routes if sparse else None)
        final = {k: v.float() for k, v in stack["layer_norm"].items()}
        return [layer_norm(x, final) for x in xs]


def log_probs(tree: dict, cfg: dict, sources: Sequence[Sequence[int]],
              seqs: Sequence[Sequence[int]], quant: Optional[str] = None,
              routes: Optional[List[torch.Tensor]] = None) -> Iterator[torch.Tensor]:
    """For each hypothesis i in turn: [len(seqs[i]), V] log-probabilities of
    the next token at every position of ``seqs[i]`` (the prompt and the
    served tokens but the last), the decoder teacher-forced over the memory
    of ``sources[i]`` (each distinct source encoded once)."""
    dev = tree["embed"]["weight"].device
    heads, held = cfg["num_decoder_attn_heads"], held_range(cfg)
    keys = [tuple(s) for s in sources]
    distinct = list(dict.fromkeys(keys))
    memory = dict(zip(distinct, encode(tree, cfg, distinct, quant, routes)))
    pe = _table(cfg, dev)
    with precise(), torch.no_grad():
        xs = [_embed(tree, cfg, seq, pe) for seq in seqs]
        stack = tree["decoder"]
        for sparse, i in _plan(cfg["num_decoder_layers"], cfg["decoder_sparse_step"]):
            p = _weights(stack["sparse_layers" if sparse else "layers"], i)
            sa, ca = p["self_attn"], p["encoder_decoder_attn"]
            for j, x in enumerate(xs):
                h = layer_norm(x, p["self_attn_layer_norm"])
                a = attention(linear(h, sa["q_proj"], quant), linear(h, sa["k_proj"], quant),
                              linear(h, sa["v_proj"], quant), heads, causal=True)
                x = x + linear(a, sa["output_proj"], quant)
                h = layer_norm(x, p["encoder_decoder_attn_layer_norm"])
                m = memory[keys[j]]
                a = attention(linear(h, ca["q_proj"], quant), linear(m, ca["k_proj"], quant),
                              linear(m, ca["v_proj"], quant), heads)
                x = x + linear(a, ca["output_proj"], quant)
                xs[j] = _ffn(x, p, sparse, held, quant, routes if sparse else None)
        final = {k: v.float() for k, v in stack["layer_norm"].items()}
        table = tree["embed"]["weight"].float()
        for x in xs:
            yield torch.log_softmax(layer_norm(x, final) @ table.t(), dim=-1)
