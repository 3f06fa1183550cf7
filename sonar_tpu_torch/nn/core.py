"""Functional NN primitives over nested-dict parameter trees.

Counterpart of ``sonar_tpu.nn.core``. Parameters keep the JAX package's
layout so converted weights map one-to-one:

- Linear: ``{"kernel": [in, out], "bias": [out]}``, or after int8
  quantization ``{"kernel_q": int8 [in, out], "scale": fp32 [1, out],
  "bias": [out]}``;
- LayerNorm: ``{"weight": [d], "bias": [d]}``;
- Embedding: ``{"weight": [V, d]}``.

Under a model split (``parallel.comm.model_parallel``) ``row_linear`` sums
a row-parallel projection over the model group before its bias, and
``embedding_lookup`` reads a vocabulary-split table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from sonar_tpu_torch.parallel.comm import Group, model_group, sum_over_group
import torch

Params = Dict[str, Any]


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a parameter tree in sorted key order, depth first (the
    order of ``jax.tree_util.tree_leaves``; an optimizer's parameter order)."""
    out: List[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "kernel_q" in params:
        from sonar_tpu_torch.ops.quantization import int8_linear

        return int8_linear(params, x)
    y = torch.matmul(x, params["kernel"].to(x.dtype))
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def row_linear(params: Params, x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """A row-parallel projection: ``x`` holds this rank's slice of the input
    axis and ``params`` the matching kernel rows. The partial products are
    summed over ``group`` (int8: the int32 sums, after the row absmax is
    agreed), then the bias is added once. ``linear`` when ``group`` is None."""
    if group is None:
        return linear(params, x)
    if "kernel_q" in params:
        from sonar_tpu_torch.ops.quantization import int8_linear

        return int8_linear(params, x, group=group)
    y = sum_over_group(torch.matmul(x, params["kernel"].to(x.dtype)), group)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics, cast back to the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["weight"].float() + params["bias"].float()
    return y.to(x.dtype)


def embedding_lookup(
    params: Params, ids: torch.Tensor, dtype: Optional[torch.dtype] = None,
    vocab_size: Optional[int] = None,
) -> torch.Tensor:
    """Rows ``ids`` of the table. Under a model split a table of fewer than
    ``vocab_size`` rows is this rank's vocabulary block: the rank looks up
    the ids in its block, writes -0.0 for the others (x + -0.0 is x) and the
    rows are summed over the model group."""
    weight = params["weight"]
    group = model_group()
    if group is not None and vocab_size is not None and weight.shape[0] < vocab_size:
        rows = weight.shape[0]
        local = ids.long() - group.index * rows
        inside = (local >= 0) & (local < rows)
        out = weight[local.clamp(0, rows - 1)]
        out = sum_over_group(torch.where(inside[..., None], out, out.new_full((), -0.0)),
                                group)
    else:
        # Gather first, cast after: the same values as casting the whole
        # table, without converting all V rows on every call.
        out = weight[ids.long()]
    return out if dtype is None else out.to(dtype)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - p and
    divided by it; the identity when ``generator`` is None (inference) or
    ``p <= 0``. The mask is drawn from ``generator``, which must live on
    ``x``'s device (torch's random bits are not JAX's, so the masks differ
    from the JAX package's; the function is the same)."""
    if generator is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def get_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The activation of a model's MLP: ReLU (the SONAR FFNs, MuTox) or
    tanh (BLASER)."""
    key = name.lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"unsupported activation: {name}")
    return ACTIVATIONS[key]
