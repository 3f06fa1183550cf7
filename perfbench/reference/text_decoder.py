"""Plain reference of the SONAR text decoder (``basic`` arch), fp32.

Written from the published architecture (fairseq2's NLLB decoder as SONAR
builds it, conditioned on one sentence embedding): token embedding
x sqrt(d) plus the fairseq sinusoidal table from row t + pad_idx + 1;
pre-LN layers of causal self-attention, attention over the memory (the
embedding, one position) and a ReLU FFN, each added to the residual; a
final LayerNorm; logits against the tied embedding table, log-softmax over
the whole vocabulary. The search's score of a hypothesis is the sum of
its tokens' log-probabilities (EOS included) over its length (length
penalty 1).

Teacher-forced over the prompt and the served tokens, all positions at
once (no cache), fp32 with TF32 off, layer by layer for every hypothesis.
``quant`` rounds the projections of the layers (the output projection
stays fp32) as ``text_encoder.linear`` does: ``"fp8"`` is the control.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence

from perfbench.reference.text_encoder import (
    _fp32,
    attention,
    layer_norm,
    linear,
    precise,
    sinusoidal,
)
import torch


def log_probs(tree: dict, cfg: dict, memory: torch.Tensor, seqs: Sequence[Sequence[int]],
              quant: Optional[str] = None) -> Iterator[torch.Tensor]:
    """For each hypothesis i in turn: [len(seqs[i]), V] log-probabilities of
    the next token at every position of ``seqs[i]``, given ``memory[i]``
    [d] (one hypothesis's table at a time: they are large)."""
    emb = tree["decoder_frontend"]["embed"]["weight"]
    dev = emb.device
    d, heads = cfg["model_dim"], cfg["num_decoder_attn_heads"]
    offset = cfg["vocab_info"]["pad_idx"] + 1
    pe = sinusoidal(cfg["max_seq_len"], d, dev)
    with precise(), torch.no_grad():
        mem = memory.float().to(dev)
        xs = []
        for seq in seqs:
            t = torch.tensor(list(seq), dtype=torch.long, device=dev)
            xs.append(emb[t].float() * math.sqrt(d) + pe[offset:offset + len(seq)])
        layers = tree["decoder"]["layers"]
        for i in range(cfg["num_decoder_layers"]):
            p = _fp32(layers, i)
            sa, ca, ffn = p["self_attn"], p["encoder_decoder_attn"], p["ffn"]
            for j, x in enumerate(xs):
                h = layer_norm(x, p["self_attn_layer_norm"])
                a = attention(linear(h, sa["q_proj"], quant), linear(h, sa["k_proj"], quant),
                              linear(h, sa["v_proj"], quant), heads, causal=True)
                x = x + linear(a, sa["output_proj"], quant)
                h = layer_norm(x, p["encoder_decoder_attn_layer_norm"])
                m = mem[j:j + 1]
                a = attention(linear(h, ca["q_proj"], quant), linear(m, ca["k_proj"], quant),
                              linear(m, ca["v_proj"], quant), heads)
                x = x + linear(a, ca["output_proj"], quant)
                h = layer_norm(x, p["ffn_layer_norm"])
                xs[j] = x + linear(torch.relu(linear(h, ffn["inner_proj"], quant)),
                                   ffn["output_proj"], quant)
        final = _fp32(tree["decoder"]["layer_norm"])
        table = emb.float()
        for x in xs:
            yield torch.log_softmax(layer_norm(x, final) @ table.t(), dim=-1)


def hypothesis_score(lp: torch.Tensor, prompt_len: int, tokens: Sequence[int]) -> float:
    """The search's score of ``tokens`` (generated, EOS last) after a prompt
    of ``prompt_len``: ``lp`` from ``log_probs`` over prompt + tokens[:-1]."""
    pos = torch.arange(prompt_len - 1, prompt_len - 1 + len(tokens), device=lp.device)
    t = torch.tensor(list(tokens), dtype=torch.long, device=lp.device)
    return float(lp[pos, t].double().sum() / len(tokens))


def candidate_gaps(lp: torch.Tensor, prompt_len: int, tokens: Sequence[int],
                   width: int) -> torch.Tensor:
    """Per generated position: how far the served token's log-probability
    lies below the ``width``-th best (0 when it is among the best
    ``width``): the search extends a beam only by its best ``width``."""
    pos = torch.arange(prompt_len - 1, prompt_len - 1 + len(tokens), device=lp.device)
    rows = lp[pos]
    kth = rows.topk(width, dim=-1).values[:, -1]
    got = rows.gather(1, torch.tensor(list(tokens), device=lp.device)[:, None])[:, 0]
    return torch.clamp(kth - got, min=0.0)


def kept_gaps(lp: torch.Tensor, other: torch.Tensor, prompt_len: int, n: int,
              width: int) -> torch.Tensor:
    """Per position of the first ``n`` generated: how far the worst (by
    ``lp``) of ``other``'s best ``width`` tokens lies below ``lp``'s
    ``width``-th best: what a search in ``other``'s precision would keep."""
    pos = torch.arange(prompt_len - 1, prompt_len - 1 + n, device=lp.device)
    rows = lp[pos]
    kth = rows.topk(width, dim=-1).values[:, -1]
    kept = rows.gather(1, other[pos].topk(width, dim=-1).indices).min(dim=-1).values
    return torch.clamp(kth - kept, min=0.0)
