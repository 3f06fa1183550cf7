"""Faults planted in the expert and cross-attention layers of an
encoder-decoder configuration (``translate.moe_beam5``), which ``correct``
has to catch: ``scripts/nllb_moe_faults.py NAME -- <run.py arguments>`` plants
one on the card, ``perfbench/tests`` at toy width. Not for measured runs.

- ``top1``: the second expert's gate is 0 and the first's 1;
- ``unnormalised``: the two gates are the router's probabilities, not
  divided by their sum;
- ``skipped_experts``: the first sparse decoder layer computes none of its
  held experts;
- ``unmasked_source``: the beam step's cross-attention reads the source's
  padding positions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


def _route(make: Callable[[Callable], Callable]) -> Callable[[], None]:
    from sonar_tpu_torch.nn import moe

    inner = moe.route
    moe.route = make(inner)
    return lambda: setattr(moe, "route", inner)


def _top1() -> Callable[[], None]:
    def make(inner: Callable) -> Callable:
        def route(router: Any, x: Any):
            import torch

            ids, gates = inner(router, x)
            return ids, torch.stack([torch.ones_like(gates[:, 0]),
                                     torch.zeros_like(gates[:, 1])], dim=1)
        return route
    return _route(make)


def _unnormalised() -> Callable[[], None]:
    def make(inner: Callable) -> Callable:
        def route(router: Any, x: Any):
            import torch

            ids, _ = inner(router, x)
            probs = torch.softmax(x.float() @ router["kernel"].float(), dim=-1)
            return ids, probs.gather(-1, ids)
        return route
    return _route(make)


def _skipped_experts() -> Callable[[], None]:
    import torch

    from sonar_tpu_torch.models.nllb_moe.model import NllbMoeModel

    inner = NllbMoeModel.layers

    def layers(self: Any, params: Any, side: str):
        out = inner(self, params, side)
        if side == "decoder":
            i = next(i for i, (sparse, _) in enumerate(self.plans[side]) if sparse)
            ffn = out[i]["ffn"]
            held = ffn["inner_proj"]["kernel"].shape[0]
            out[i] = dict(out[i], ffn=dict(ffn, expert_slot=torch.full_like(ffn["expert_slot"],
                                                                            held)))
        return out

    NllbMoeModel.layers = layers
    return lambda: setattr(NllbMoeModel, "layers", inner)


def _unmasked_source() -> Callable[[], None]:
    from sonar_tpu_torch.nn import transformer

    inner = transformer._beam_cross_attend

    def attend(params: Any, x: Any, k: Any, v: Any, mask: Any, heads: int, beam: int):
        return inner(params, x, k, v, None, heads, beam)

    transformer._beam_cross_attend = attend
    return lambda: setattr(transformer, "_beam_cross_attend", inner)


FAULTS: Dict[str, Callable[[], Callable[[], None]]] = {
    "top1": _top1, "unnormalised": _unnormalised, "skipped_experts": _skipped_experts,
    "unmasked_source": _unmasked_source}


def plant(name: str) -> Callable[[], None]:
    """Plant the fault ``name``; returns the call that takes it out."""
    if name not in FAULTS:
        raise KeyError(f"no fault {name!r}: {sorted(FAULTS)}")
    return FAULTS[name]()
