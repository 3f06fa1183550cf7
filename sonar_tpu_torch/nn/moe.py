"""The sparse expert FFN of NLLB-200 MoE (HF ``NllbMoeSparseMLP``, fairseq's
``moe_freq`` layers), for a card that holds some of the experts.

The router is a linear map of ``LN(x)`` to every expert, without bias,
computed in fp32: the softmax over all E experts, top-1 its argmax, top-2
the argmax of the logits with top-1 masked (``second_expert_policy``
"all"), and the two gates renormalised to sum to 1. Nothing is dropped:
at inference every expert takes every token routed to it
(``moe_eval_capacity_token_fraction`` 1.0).

A layer's parameters hold the experts this card keeps (``experts_held``):

- ``router``: ``{"kernel": [D, E]}``, every expert's column;
- ``expert_slot``: [E] int32, the held slot of each expert id, ``E_h`` for
  an expert held elsewhere;
- ``inner_proj`` / ``output_proj``: ``{"kernel": [E_h, D, F] / [E_h, F, D],
  "bias": [E_h, F] / [E_h, D]}``, the held experts' ReLU FFNs.

The layer adds ``gate * expert(x)`` for the (token, expert) pairs whose
expert it holds and computes nothing for the others: the sum of every
card's output is the whole layer's. Shapes do not depend on the routing
and nothing is read back to the host, so the layer is captured inside the
beam loop's CUDA graph: the 2T pairs are sorted by held slot (pairs held
elsewhere, or of padding tokens, last), the slots' row counts and their
running sum are computed on the device, two grouped GEMMs run over the
held rows (``torch._grouped_mm`` on the card, which computes no row past
the last group), and each token gathers its two rows back.

Counters (``rows`` and ``hits`` in a layer's tree, device tensors the
model owns) add, per held expert, the rows it received and the calls in
which it received any. The groups cover every held pair by construction:
none is dropped. Spans ``moe.route``, ``moe.experts`` and
``moe.combine`` mark the three stages in a trace.
"""

from __future__ import annotations

from typing import Optional

from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.utils.profiling import span
import torch


def route(router: Params, x: torch.Tensor) -> tuple:
    """x [T, D] -> (experts [T, 2] int64, gates [T, 2] fp32): top-2 of the
    fp32 router, the second from the logits with the first masked, the two
    probabilities renormalised to sum to 1."""
    logits = x.float() @ router["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    first = probs.argmax(dim=-1)
    masked = logits.scatter(-1, first[:, None], float("-inf"))
    second = masked.argmax(dim=-1)
    experts = torch.stack([first, second], dim=-1)
    p = probs.gather(-1, experts)
    denom = p.sum(dim=-1, keepdim=True).clamp(min=torch.finfo(torch.float32).eps)
    return experts, p / denom


def grouped_mm(a: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[g - 1]:offs[g]`` of ``a`` [M, K] times ``w[g]`` [K, N],
    for each group g: [M, N]; rows past ``offs[-1]`` are not computed (zero
    on the CPU, unset on the card). ``torch._grouped_mm`` on a CUDA device;
    on the CPU one product a group."""
    if a.is_cuda:
        return torch._grouped_mm(a, w.to(a.dtype), offs=offs)
    out = a.new_zeros((a.shape[0], w.shape[-1]))
    lo = 0
    for g, hi in enumerate(offs.tolist()):
        if hi > lo:
            out[lo:hi] = a[lo:hi] @ w[g].to(a.dtype)
        lo = hi
    return out


def experts(params: Params, rows: torch.Tensor, slots: torch.Tensor,
            offs: torch.Tensor) -> torch.Tensor:
    """The held experts' ReLU FFNs over ``rows`` [M, D] sorted by held slot
    (``slots`` [M], clamped into range) with group ends ``offs`` [E_h]
    int32 -> [M, D]; rows past ``offs[-1]`` hold no value."""
    inner, out = params["inner_proj"], params["output_proj"]
    h = grouped_mm(rows, inner["kernel"], offs)
    h = torch.relu_(h.add_(inner["bias"].to(h.dtype)[slots]))
    y = grouped_mm(h, out["kernel"], offs)
    return y.add_(out["bias"].to(y.dtype)[slots])


def moe_ffn(params: Params, x: torch.Tensor,
            token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The held experts' part of the sparse FFN of ``x`` [..., D] (already
    layer-normed), the shape of ``x``. ``token_mask`` ([...] bool, True for
    a real token) keeps padding tokens out of every expert."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    t = x2.shape[0]
    held_n = params["inner_proj"]["kernel"].shape[0]
    with span("moe.route", tokens=t):
        ids, gates = route(params["router"], x2)
        slot = params["expert_slot"].long()[ids]                  # [T, 2]
        held = slot < held_n
        if token_mask is not None:
            held = held & token_mask.reshape(-1, 1)
        flat = torch.where(held, slot, held_n).reshape(-1)       # [2T]
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(held_n + 1, dtype=torch.long, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
        offs = counts[:held_n].cumsum(0).to(torch.int32)
    with span("moe.experts", pairs=2 * t):
        y = experts(params, x2[order // 2], flat[order].clamp(max=held_n - 1), offs)
    with span("moe.combine"):
        back = torch.empty_like(order)
        back[order] = torch.arange(order.numel(), device=x.device)
        y = y[back].reshape(t, 2, -1).float()
        out = torch.where(held[..., None], gates[..., None] * y, 0.0).sum(dim=1)
    if "rows" in params:
        params["rows"].add_(counts[:held_n])
        params["hits"].add_((counts[:held_n] > 0).long())
    return out.to(x.dtype).reshape(shape)
