"""The collectives of the port's scale-out, over ``torch.distributed``.

The JAX package names shardings and lets GSPMD insert every collective
(``sonar_tpu.parallel.mesh``). PyTorch runs one process per rank, so the
port issues them itself, each on a named ``Group`` (one axis of a
``parallel.mesh.Mesh``):

- ``all_sum`` / ``all_max``: an ``all_reduce`` of a copy;
- ``broadcast_from``: one rank's tensor to every rank of the group (the
  first by default); on a group of two it is a point-to-point send, the
  pipeline's stage-to-stage transfer (``parallel.pipeline``);
- ``gather_blocks``: each rank's equal block, concatenated in rank order,
  written as a sum into a buffer of ``-0.0`` (x + -0.0 is x for every float
  x, -0.0 included, so the gather is exact to the bit);
- ``take_block``: this rank's equal block of a tensor every rank holds;
- ``any_over``: one host boolean agreed across the group.

Every collective is an ``all_reduce`` or a ``broadcast``: gloo takes CUDA
tensors for those two only, and several ranks sharing one GPU (NCCL refuses
two ranks on one device) run over gloo. On a group of one rank each is the
identity and issues no call.

Tensor parallelism (Megatron's pair of operators) is written as two
autograd Functions, because the library's differentiable ``all_reduce``
(``torch.distributed.nn.functional.all_reduce``) reduces the gradient too:
downstream of a row-parallel sum every rank holds the same activations and
the same gradient, and that backward would multiply it by the group size.

- ``copy_to_group`` (*f*): identity forward, sum of the gradient backward;
  placed before each column-parallel projection (each rank's slice of the
  weights gives a part of the input's gradient);
- ``sum_over_group`` (*g*): sum forward, identity backward; placed after
  each row-parallel projection and after the vocabulary-split embedding
  and, on the data group, on the losses' sums (every data rank reads the
  global loss; each one's gradient is its own rows' part).

The pipeline and sequence-parallel functions (``parallel.pipeline``,
``parallel.sequence``) give every rank the global input and return the
global output on every rank; a backward of a loss that every rank computes
alike then leaves each rank with the single-device gradient of the input and
of every leaf it holds. That fixes the backward of each gather and split:

- ``take_block`` (the rank's rows or frames out of the input): the
  gradient's blocks gathered, so every rank holds the whole input gradient;
- ``gather_blocks`` of an output (``sum_grad=False``): the rank's slice of
  the gradient alone. Every rank already holds the same whole gradient, and
  a sum would multiply it by the group size;
- ``gather_blocks`` inside a layer (``sum_grad=True``: the sequence-parallel
  K and V, the depthwise convolution's halo): the gradient summed over the
  group, then sliced. Rank j's K block takes gradient from every rank's
  queries;
- ``copy_to_group`` on each leaf that several ranks hold and use on
  different rows or frames: their partial gradients summed.

``model_parallel(group)`` / ``data_parallel(group)`` name the groups that
the layers and the losses reduce over (context variables, so each thread
of a server sets its own); outside them both are None.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Sequence, Tuple

from sonar_tpu_torch.ops.gates import records_grad
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Group:
    """A process group (``pg``, None for a group of one) with the global
    ranks it holds, in order, and this process's index among them."""

    pg: Any
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


SINGLE = Group(None, (0,), 0)


def all_sum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks (a new tensor)."""
    if group.size == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group.pg)
    return y


def all_max(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the group's ranks."""
    if group.size == 1:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group.pg)
    return y


def broadcast_from(x: torch.Tensor, group: Group, index: int = 0) -> torch.Tensor:
    """The ``x`` of the group's rank ``index`` (the first by default) on
    every rank (in place: the others pass a buffer of its shape)."""
    if group.size > 1:
        dist.broadcast(x, src=group.ranks[index], group=group.pg)
    return x


def _gather(block: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    shape = list(block.shape)
    n = shape[dim]
    shape[dim] = n * group.size
    fill = -0.0 if block.is_floating_point() else 0
    out = torch.full(shape, fill, dtype=block.dtype, device=block.device)
    out.narrow(dim, group.index * n, n).copy_(block)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    return out


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, block: torch.Tensor, group: Group, dim: int,
                sum_grad: bool) -> torch.Tensor:
        ctx.group, ctx.dim, ctx.sum_grad, ctx.n = group, dim, sum_grad, block.shape[dim]
        return _gather(block, group, dim)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        if ctx.sum_grad:
            grad = all_sum(grad.contiguous(), ctx.group)
        return grad.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n), None, None, None


def gather_blocks(block: torch.Tensor, group: Group, dim: int = 0,
                  sum_grad: bool = False) -> torch.Tensor:
    """Every rank's ``block`` (equal shapes) concatenated along ``dim`` in
    rank order, bit for bit. Under autograd the block's gradient is the
    rank's slice of the output's, summed over the group first when
    ``sum_grad`` (a gather inside a layer; the module docstring says which
    site takes which)."""
    if group.size == 1:
        return block
    if records_grad(block):
        return _GatherBlocks.apply(block, group, dim, sum_grad)
    return _gather(block, group, dim)


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.index * n, n).clone()

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        return _gather(grad.contiguous(), ctx.group, ctx.dim), None, None


def take_block(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``, which every rank holds
    whole: the ``group.index``-th of ``group.size`` equal blocks. Under
    autograd its gradient is the blocks' gradients gathered (so every rank
    holds the whole gradient of ``x``). Raises when ``dim`` does not
    divide."""
    if x.shape[dim] % group.size:
        raise ValueError(f"{x.shape[dim]} rows or frames do not split over a group of "
                         f"{group.size} ranks")
    if group.size == 1:
        return x
    if records_grad(x):
        return _TakeBlock.apply(x, group, dim)
    n = x.shape[dim] // group.size
    return x.narrow(dim, group.index * n, n)


def any_over(flag: bool, group: Group, device: Any) -> bool:
    """True when ``flag`` is true on any rank of the group."""
    if group.size == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
    return bool(t.item())


def all_sum_coalesced(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Sum each tensor over the group in place, one ``all_reduce`` for each
    dtype (the gradients of a train step)."""
    if group.size == 1:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.pg)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return all_sum(grad.contiguous(), ctx.group), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, x: torch.Tensor, group: Group) -> torch.Tensor:
        return all_sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx: Any, grad: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return grad, None


def copy_to_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """*f*: ``x`` unchanged; its gradient summed over ``group``."""
    if group is None or group.size == 1:
        return x
    return _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """*g*: ``x`` summed over ``group``; its gradient passed on unchanged."""
    if group is None or group.size == 1:
        return x
    return _SumOverGroup.apply(x, group)


_MODEL: contextvars.ContextVar = contextvars.ContextVar("sonar_model_group", default=None)
_DATA: contextvars.ContextVar = contextvars.ContextVar("sonar_data_group", default=None)


@contextlib.contextmanager
def _scoped(var: contextvars.ContextVar, group: Optional[Group]) -> Iterator[None]:
    token = var.set(group if group is not None and group.size > 1 else None)
    try:
        yield
    finally:
        var.reset(token)


def model_parallel(group: Optional[Group]) -> contextlib.AbstractContextManager:
    """Run the layers with their heads, FFN columns and vocabulary split
    over ``group`` (the parameters being ``parallel.mesh.shard_params``'s
    slices for this rank)."""
    return _scoped(_MODEL, group)


def data_parallel(group: Optional[Group]) -> contextlib.AbstractContextManager:
    """Reduce the losses' sums and counts over ``group``: the loss is the
    mean over the global batch."""
    return _scoped(_DATA, group)


def model_group() -> Optional[Group]:
    """The tensor-parallel group in force (None outside one, or for one rank)."""
    return _MODEL.get()


def data_group() -> Optional[Group]:
    """The data-parallel group the losses reduce over (None outside one)."""
    return _DATA.get()
