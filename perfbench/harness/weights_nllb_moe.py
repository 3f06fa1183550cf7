"""NLLB-200 MoE weights drawn from the seed on the device, in the type they
are served in (``perfbench/harness/weights.py``'s distributions and layout).

One ``torch.Generator`` on the run's device, one call per stacked leaf. The
tree (``sonar_tpu_torch.models.nllb_moe``'s layout): the shared embedding
(N(0, d^-0.5), a zero pad row); each stack's dense layers and sparse layers
as two stacked groups, every linear Kaiming-uniform in its fan-in with a
bias, every LayerNorm drawn (weight U(0.5, 1.5), bias U(-0.1, 0.1)); a
sparse layer's router [d, E] without bias, its ``expert_slot`` table and
the held experts' FFNs [E_h, d, f] / [E_h, f, d] with biases.

The experts are drawn for the held range only, from a generator of their
own a sparse layer and expert, so that a card holding another range, or
all of them, draws the same values for the experts both hold.

The routers (``balance_routers``). A router drawn at random, as the other
linears, sends nearly every token to the same few experts: the residual
stream of a random model carries a large direction that every token shares
(the ReLU FFNs' positive mean, the positions), and its logits follow it. A
trained router is load-balanced (NLLB-200 trains with a balancing loss).
So each router is drawn Kaiming-uniform, then fitted to the statistics of
its own input on a calibration batch: whitened against the input's
covariance, with the direction of its mean taken out, so that its logits
keep their drawn scale (variance ~1) and follow only what tells tokens
apart. The calibration batch: ``CAL_SENTENCES`` random sources of
``CAL_SOURCE_LEN`` ids, decoded greedily for ``CAL_STEPS`` tokens, the
decoder's inputs read teacher-forced over those tokens, as a decode step
reads them. It runs with every sparse layer's experts left out, so that it
does not depend on which experts a card holds: every card of a deployment
fits the same routers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from perfbench.harness.weights import _attn, _embedding, _gen, _linear, _ln, _uniform


def plan_counts(n_layers: int, step: int) -> Tuple[int, int]:
    """(dense, sparse) layers of a stack with every ``step``-th sparse."""
    sparse = n_layers // step if step > 0 else 0
    return n_layers - sparse, sparse


def held_range(cfg: dict) -> Tuple[int, int]:
    """[first, end) of the experts held: ``num_experts`` of the router's
    ``router_experts``, from ``experts_first``."""
    return cfg["experts_first"], cfg["experts_first"] + cfg["num_experts"]


def _experts(torch, seed, side, n, cfg, dtype, device) -> Dict[str, Any]:
    d, f = cfg["model_dim"], cfg["ffn_inner_dim"]
    first, end = held_range(cfg)
    held = end - first
    w1 = torch.empty((n, held, d, f), dtype=dtype, device=device)
    w2 = torch.empty((n, held, f, d), dtype=dtype, device=device)
    b1 = torch.empty((n, held, f), dtype=dtype, device=device)
    b2 = torch.empty((n, held, d), dtype=dtype, device=device)
    for layer in range(n):
        for s, e in enumerate(range(first, end)):
            g = _gen(torch, seed, device, 1000 + 100000 * side + 1000 * layer + e)
            w1[layer, s].uniform_(-math.sqrt(3.0 / d), math.sqrt(3.0 / d), generator=g)
            b1[layer, s].uniform_(-math.sqrt(1.0 / d), math.sqrt(1.0 / d), generator=g)
            w2[layer, s].uniform_(-math.sqrt(3.0 / f), math.sqrt(3.0 / f), generator=g)
            b2[layer, s].uniform_(-math.sqrt(1.0 / f), math.sqrt(1.0 / f), generator=g)
    ids = torch.arange(cfg["router_experts"], device=device)
    slot = torch.where((ids >= first) & (ids < end), ids - first, held).to(torch.int32)
    return {"expert_slot": slot[None].expand(n, -1).contiguous(),
            "inner_proj": {"kernel": w1, "bias": b1}, "output_proj": {"kernel": w2, "bias": b2}}


def _layers(torch, g, n, cfg, dtype, device, cross: bool, dense_ffn: bool) -> Dict[str, Any]:
    d, f = cfg["model_dim"], cfg["ffn_inner_dim"]
    out = {"self_attn": _attn(torch, g, n, d, dtype, device),
           "self_attn_layer_norm": _ln(torch, g, (n, d), dtype, device)}
    if cross:
        out["encoder_decoder_attn"] = _attn(torch, g, n, d, dtype, device)
        out["encoder_decoder_attn_layer_norm"] = _ln(torch, g, (n, d), dtype, device)
    if dense_ffn:
        out["ffn"] = {"inner_proj": _linear(torch, g, n, d, f, dtype, device),
                      "output_proj": _linear(torch, g, n, f, d, dtype, device)}
    out["ffn_layer_norm"] = _ln(torch, g, (n, d), dtype, device)
    return out


def nllb_moe(torch: Any, cfg: dict, seed: int, dtype: Any, device: Any) -> Dict[str, Any]:
    g = _gen(torch, seed, device, 21)
    d, vi = cfg["model_dim"], cfg["vocab_info"]
    tree: Dict[str, Any] = {"embed": {"weight": _embedding(torch, g, vi["size"], d,
                                                          vi["pad_idx"], dtype, device)}}
    for side, name in enumerate(("encoder", "decoder")):
        dense, sparse = plan_counts(cfg[f"num_{name}_layers"], cfg[f"{name}_sparse_step"])
        stack = {"layers": _layers(torch, g, dense, cfg, dtype, device, side == 1, True)}
        if sparse:
            layers = _layers(torch, g, sparse, cfg, dtype, device, side == 1, False)
            router = _uniform(torch, g, (sparse, d, cfg["router_experts"]), math.sqrt(3.0 / d),
                              dtype, device)  # fitted below
            layers["ffn"] = dict(_experts(torch, seed, side, sparse, cfg, dtype, device),
                                 router={"kernel": router})
            stack["sparse_layers"] = layers
        stack["layer_norm"] = _ln(torch, g, (d,), dtype, device)
        tree[name] = stack
    balance_routers(torch, tree, cfg, seed, device)
    return tree


CAL_SENTENCES, CAL_SOURCE_LEN, CAL_STEPS = 128, 24, 32
SHRINK = 0.1  # of the covariance towards its mean variance: the calibration's ~4k rows


def _fit(torch: Any, h: Any, router: Any) -> Any:
    """The router [d, E] (fp32) whitened against the rows ``h`` [B, n, d]:
    the covariance of each row's deviation from the mean of its position
    (the rows a decode step reads together), shrunk by ``SHRINK``, to the
    power -1/2, times the router with the positions' whitened means taken
    out, so that no offset shared by a step's rows moves its logits."""
    d = h.shape[-1]
    mean = h.mean(0)                                         # [n, d]
    dev = (h - mean).reshape(-1, d)
    cov = dev.t() @ dev / dev.shape[0]
    cov = (1.0 - SHRINK) * cov + SHRINK * cov.diagonal().mean() * torch.eye(d, device=h.device)
    e, q = torch.linalg.eigh(cov)
    w = (q * e.clamp(min=1e-12).rsqrt()) @ q.t()
    u = torch.linalg.qr((mean @ w).t()).Q                    # [d, n]
    return w @ (router - u @ (u.t() @ router))


def _attend(torch: Any, q: Any, k: Any, v: Any, heads: int, causal: bool) -> Any:
    b, n, d = q.shape
    dh = d // heads
    qh, kh, vh = (t.reshape(b, -1, heads, dh).transpose(1, 2) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(dh)
    if causal:
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2).reshape(b, n, d)


def _run_stack(torch: Any, tree: dict, cfg: dict, side: str, x: Any, memory: Any,
               inputs: Any = None) -> Any:
    """x [B, n, d] fp32 through one stack in the published order, every sparse
    layer's experts left out; ``inputs`` (a list) gets each sparse layer's
    router input [B, n, d]. -> the final LayerNorm's output."""
    from perfbench.reference.nllb_moe import _plan, _weights
    from perfbench.reference.text_encoder import layer_norm

    def lin(t: Any, p: dict) -> Any:
        return t @ p["kernel"] + p["bias"]

    heads, stack = cfg[f"num_{side}_attn_heads"], tree[side]
    for sparse, i in _plan(cfg[f"num_{side}_layers"], cfg[f"{side}_sparse_step"]):
        p = _weights({k: v for k, v in stack["sparse_layers" if sparse else "layers"].items()
                      if k != "ffn" or not sparse}, i)
        sa = p["self_attn"]
        h = layer_norm(x, p["self_attn_layer_norm"])
        x = x + lin(_attend(torch, lin(h, sa["q_proj"]), lin(h, sa["k_proj"]),
                            lin(h, sa["v_proj"]), heads, memory is not None), sa["output_proj"])
        if memory is not None:
            ca = p["encoder_decoder_attn"]
            h = layer_norm(x, p["encoder_decoder_attn_layer_norm"])
            x = x + lin(_attend(torch, lin(h, ca["q_proj"]), lin(memory, ca["k_proj"]),
                                lin(memory, ca["v_proj"]), heads, False), ca["output_proj"])
        h = layer_norm(x, p["ffn_layer_norm"])
        if sparse:
            if inputs is not None:
                inputs.append(h)
            continue
        f = p["ffn"]
        x = x + lin(torch.relu(lin(h, f["inner_proj"])), f["output_proj"])
    return layer_norm(x, {k: v.float() for k, v in stack["layer_norm"].items()})


def balance_routers(torch: Any, tree: dict, cfg: dict, seed: int, device: Any) -> None:
    """Fit every sparse layer's router in ``tree`` in place (the module's
    docstring)."""
    from perfbench.reference.nllb_moe import _table
    from perfbench.reference.text_encoder import precise

    vi, d = cfg["vocab_info"], cfg["model_dim"]
    g = _gen(torch, seed, device, 31)
    src = torch.randint(4, vi["size"], (CAL_SENTENCES, CAL_SOURCE_LEN), generator=g,
                        device=device)
    src[:, -1] = vi["eos_idx"]
    code = torch.randint(4, vi["size"], (1,), generator=g, device=device)
    table, pe = tree["embed"]["weight"], _table(cfg, device)
    offset = vi["pad_idx"] + 1

    def embed(ids: Any) -> Any:
        return (table[ids].float() * math.sqrt(d)
                + pe[offset:offset + ids.shape[1]])

    with precise(), torch.no_grad():
        enc: list = []
        memory = _run_stack(torch, tree, cfg, "encoder", embed(src), None, enc)
        seq = torch.cat([torch.full((CAL_SENTENCES, 1), vi["eos_idx"], device=device),
                         code.expand(CAL_SENTENCES, 1)], dim=1)
        full = table.float()
        for _ in range(CAL_STEPS):
            y = _run_stack(torch, tree, cfg, "decoder", embed(seq), memory)[:, -1]
            logits = y @ full.t()
            logits[:, :4] = float("-inf")  # a hypothesis runs to its length
            seq = torch.cat([seq, logits.argmax(-1, keepdim=True)], dim=1)
        del full
        dec: list = []
        _run_stack(torch, tree, cfg, "decoder", embed(seq), memory, dec)
        for side, inputs in (("encoder", enc), ("decoder", dec)):
            if not inputs:
                continue
            router = tree[side]["sparse_layers"]["ffn"]["router"]["kernel"]
            for i, h in enumerate(inputs):
                router[i] = _fit(torch, h, router[i].float()).to(router.dtype)
    del enc, dec, memory, seq
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()  # the program allocates as if on a fresh card
