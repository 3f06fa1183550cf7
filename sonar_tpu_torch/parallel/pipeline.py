"""GPipe pipeline parallelism over the stacked layer axis, over
``torch.distributed`` (``sonar_tpu.parallel.pipeline``).

The layers of a stack are stacked on a leading L axis, so a stage owns a
contiguous [L/S] slice of every stacked leaf and runs the plain stack
(``encoder_stack`` or ``conformer_stack``) on it: no per-stage modules, no
reshuffling. ``make_pipeline_mesh(stage, data)`` is a (data, stage) mesh in
JAX's rank order; ``pipeline_shard_params`` keeps the stage's slice of the
layers and every other leaf whole.

Schedule: GPipe, each data row's batch cut into ``m`` microbatches. Stage s
works on microbatch i at tick i + s: it receives the activation from stage
s - 1 (stage 0 reads its microbatch of the input), runs its layers and hands
the result to stage s + 1. JAX's loop runs every stage at all m + S - 1
ticks and masks the fill and drain ticks' results; here every rank knows the
schedule, so a tick without work runs nothing and a transfer that neither
side needs is skipped on both. A transfer is a ``broadcast`` on the
two-rank group of the neighbours (``Mesh.links``; JAX's non-wrapping
``ppermute``): gloo takes CUDA tensors for ``broadcast`` and ``all_reduce``
only. Each link carries its microbatches in order and stage 0 only sends,
so no rank waits in a cycle. The last stage's outputs are broadcast over
the stage group, exact to the bit (JAX sums zero-masked slots with a
``psum``).

Under autograd the schedule is one ``torch.autograd.Function``: its forward
keeps each microbatch's local graph (run on detached leaves), its backward
runs the schedule in reverse by hand, each microbatch's gradient going back
to stage s - 1 over the same link. Every rank gets the global input and
returns the global output (``parallel.comm`` gives each split and gather its
backward), so a loss that every rank computes alike leaves each rank with
the single-device gradient of the input and of its stage's layers. The
kernel gates read autograd (``ops.gates``): the backward runs the plain
versions, as single-device training does. ``remat=True`` recomputes each
layer of a stage in the backward pass, as the plain stacks do.

The frontend, the final LayerNorms and the pooler of ``pipeline_text_encode``
/ ``pipeline_speech_encode`` run data-parallel, replicated over the stages.
JAX's memoized programs (one jitted ``shard_map`` per configuration) have no
counterpart: there is no trace to cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

from sonar_tpu_torch.models.common import SonarEncoderOutput
from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.nn.transformer import encoder_stack, num_stacked_layers
from sonar_tpu_torch.ops.quantization import column_major, is_column_major
from sonar_tpu_torch.parallel.comm import (
    Group,
    broadcast_from,
    copy_to_group,
    gather_blocks,
    take_block,
)
from sonar_tpu_torch.parallel.mesh import Mesh, expect_axis, make_axis_mesh
import torch

__all__ = [
    "make_pipeline_mesh",
    "pipeline_param_shardings",
    "pipeline_shard_params",
    "pipeline_encoder_stack",
    "pipeline_conformer_stack",
    "pipeline_text_encode",
    "pipeline_speech_encode",
]

Tensor = torch.Tensor


def make_pipeline_mesh(stage: int, data: int = -1) -> Mesh:
    """The (data, stage) mesh over the process group, with the two-rank
    group of each pair of neighbouring stages. Every rank must call it, in
    the same order as its other group creations."""
    return make_axis_mesh("stage", stage, data)


class StageSlice(dict):
    """A stage's [L/S] slice of a stacked layer tree
    (``pipeline_shard_params``); ``num_layers`` is the whole stack's L."""

    def __init__(self, tree: Params, num_layers: int):
        super().__init__(tree)
        self.num_layers = num_layers


def _map(tree: Params, fn: Callable[[Tensor], Tensor]) -> Params:
    """``fn`` on every leaf; a ``StageSlice`` stays one."""
    out = {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
    return StageSlice(out, tree.num_layers) if isinstance(tree, StageSlice) else out


def _slice_bounds(num_layers: int, mesh: Mesh) -> Tuple[int, int]:
    stages = mesh.shape["stage"]
    if num_layers % stages:
        raise ValueError(f"num layers {num_layers} not divisible by stage count {stages}")
    n = num_layers // stages
    return mesh.model_index * n, n


def pipeline_param_shardings(params: Params, mesh: Mesh) -> Params:
    """The tree of split specs (``parallel.mesh.param_shardings``' form):
    ``("stage",)``, split on axis 0, for every leaf under ``encoder/layers``,
    ``()`` (whole) for every other leaf; JAX's rule."""
    expect_axis(mesh, "stage")

    def specs(tree: Params, stacked: bool) -> Params:
        return {k: specs(v, stacked or k == "layers" and tree is params.get("encoder"))
                if isinstance(v, dict) else (("stage",) if stacked and len(v.shape) else ())
                for k, v in tree.items()}

    return specs(params, False)


def pipeline_shard_params(params: Params, mesh: Mesh) -> Params:
    """``params`` with every leaf under ``encoder/layers`` cut to this
    stage's [L/S] slice on axis 0 (own copies; an int8 kernel keeps its
    column-major layout) and every other leaf whole: the counterpart of
    JAX's ``pipeline_param_shardings``. The stack functions take the result
    as they take the whole tree."""
    expect_axis(mesh, "stage")
    layers = params["encoder"]["layers"]
    num_layers = num_stacked_layers(layers)
    start, n = _slice_bounds(num_layers, mesh)

    def own(leaf: Tensor) -> Tensor:
        piece = leaf.narrow(0, start, n).clone(memory_format=torch.contiguous_format)
        return column_major(piece) if leaf.dtype == torch.int8 and is_column_major(leaf) else piece

    encoder = dict(params["encoder"], layers=StageSlice(_map(layers, own), num_layers))
    return dict(params, encoder=encoder)


def _stage_layers(stacked: Params, mesh: Mesh) -> Params:
    """This stage's slice of a whole stacked tree (views), or the tree
    itself when ``pipeline_shard_params`` cut it already."""
    if isinstance(stacked, StageSlice):
        _slice_bounds(stacked.num_layers, mesh)
        return stacked
    start, n = _slice_bounds(num_stacked_layers(stacked), mesh)
    return _map(stacked, lambda leaf: leaf.narrow(0, start, n))


def shared_leaves(tree: Params, group: Group) -> Params:
    """Each leaf through *f* over ``group`` (ranks that hold it whole and
    use it on different rows: their partial gradients summed); the tree
    itself when autograd is off."""
    if group.size == 1 or not torch.is_grad_enabled():
        return tree
    return _map(tree, lambda leaf: copy_to_group(leaf, group))


def over_data(mesh: Mesh, fn: Callable[..., Sequence[Optional[Tensor]]], params: Params,
              *batch: Optional[Tensor]) -> List[Optional[Tensor]]:
    """``fn(params, *rows)`` on this rank's rows of the data axis (a None
    passes through), each tensor it returns gathered over the data group.
    Raises when the rows do not divide by ``data``."""
    group = mesh.data_group
    rows = [None if t is None else take_block(t, group, 0) for t in batch]
    out = fn(shared_leaves(params, group), *rows)
    return [None if t is None else gather_blocks(t, group, 0) for t in out]


@dataclass
class _Plan:
    """One stage's part of a schedule: ``run(layers, h, i)`` runs its
    layers on microbatch i; ``rebuild`` makes its layer tree of a list of
    leaves (``_leaves`` order)."""

    run: Callable[[Params, Tensor, int], Tensor]
    rebuild: Callable[[Sequence[Tensor]], Params]
    stages: Group
    links: Tuple[Optional[Group], Optional[Group]]
    m: int


def _receive(link: Group, like: Tensor, index: int) -> Tensor:
    return broadcast_from(torch.empty_like(like, memory_format=torch.contiguous_format),
                          link, index)


def _forward(plan: _Plan, x: Tensor, leaves: Sequence[Tensor], saved: Optional[list]) -> Tensor:
    """The schedule's forward on this stage; -> the data row's output on
    every stage. With ``saved`` (a list) each microbatch's (input, output)
    of a graph recorded on ``leaves`` is appended to it."""
    stage, last = plan.stages.index, plan.stages.size - 1
    prev, nxt = plan.links
    layers = plan.rebuild(leaves)
    outs = []
    for i, feed in enumerate(x.chunk(plan.m)):
        h = feed if stage == 0 else _receive(prev, feed, 0)
        if saved is None:
            y = plan.run(layers, h, i)
        else:
            h = h.detach().requires_grad_(stage > 0 or x.requires_grad)
            with torch.enable_grad():
                y = plan.run(layers, h, i)
            saved.append((h, y))
            y = y.detach()
        if stage < last:
            broadcast_from(y.contiguous(), nxt, 0)
        else:
            outs.append(y)
    out = torch.cat(outs) if stage == last else torch.empty_like(
        x, memory_format=torch.contiguous_format)
    return broadcast_from(out, plan.stages, last)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx: Any, plan: _Plan, x: Tensor, *leaves: Tensor) -> Tensor:
        ctx.plan = plan
        ctx.leaves = [leaf.detach().requires_grad_(leaf.requires_grad) for leaf in leaves]
        ctx.saved = []
        ctx.x_grad = x.requires_grad
        return _forward(plan, x, ctx.leaves, ctx.saved)

    @staticmethod
    def backward(ctx: Any, grad: Tensor) -> Tuple[Optional[Tensor], ...]:
        plan = ctx.plan
        stage, last = plan.stages.index, plan.stages.size - 1
        prev, nxt = plan.links
        wrt = [leaf for leaf in ctx.leaves if leaf.requires_grad]
        sums: List[Optional[Tensor]] = [None] * len(wrt)
        x_grads: List[Tensor] = []
        chunks = grad.chunk(plan.m)
        for i in reversed(range(plan.m)):
            h, y = ctx.saved[i]
            g = chunks[i] if stage == last else _receive(nxt, y, 1)
            inputs = ([h] if h.requires_grad else []) + wrt
            got = list(torch.autograd.grad(y, inputs, g, allow_unused=True))
            if h.requires_grad:
                gh = got.pop(0)
                if stage > 0:
                    broadcast_from(gh.contiguous(), prev, 1)
                else:
                    x_grads.insert(0, gh)
            sums = [a if b is None else b if a is None else a + b for a, b in zip(sums, got)]
        ctx.saved = None
        it = iter(sums)
        leaf_grads = [next(it) if leaf.requires_grad else None for leaf in ctx.leaves]
        x_grad = None
        if ctx.x_grad:
            x_grad = torch.cat(x_grads) if stage == 0 else torch.zeros_like(grad)
        return (None, x_grad, *leaf_grads)


def _leaves(tree: Params) -> List[Tensor]:
    out: List[Tensor] = []
    _map(tree, out.append)
    return out


def _rebuild(tree: Params, leaves: Sequence[Tensor]) -> Params:
    """``tree`` with its leaves replaced, in ``_leaves`` order."""
    it = iter(leaves)
    return _map(tree, lambda _: next(it))


def _pipelined(layers: Params, x: Tensor, aux: Sequence[Optional[Tensor]],
               run: Callable[..., Tensor], mesh: Mesh, num_microbatches: Optional[int]) -> Tensor:
    """GPipe over the stage group on a data row's rows ``x`` [B_row, ...]
    with the stage's ``layers``; ``aux`` are per-row tensors (a bias, a
    padding mask; None passes) microbatched beside it but never sent, and
    ``run(layers, h, *aux_mb)`` is the plain stack. -> the row's output on
    every stage."""
    stages = mesh.shape["stage"]
    b = x.shape[0]
    m = num_microbatches or max(1, min(stages, b))
    if b % m:
        raise ValueError(f"a local batch of {b} rows does not split into {m} microbatches")
    aux_mb = [[None] * m if a is None else a.chunk(m) for a in aux]
    plan = _Plan(run=lambda p, h, i: run(p, h, *(a[i] for a in aux_mb)),
                 rebuild=lambda leaves: _rebuild(layers, leaves), stages=mesh.model_group,
                 links=mesh.links, m=m)
    leaves = _leaves(layers)
    x = copy_to_group(x, mesh.model_group)  # stage 0's input gradient, on every stage
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in leaves)):
        return _GPipe.apply(plan, x, *leaves)
    return _forward(plan, x, leaves, None)


def _stack_over(mesh: Mesh, stacked: Params, x: Tensor, aux: Sequence[Optional[Tensor]],
                run: Callable[..., Tensor], num_microbatches: Optional[int]) -> Tensor:
    """The public stacks' common body: JAX's fallback for one stage, else
    each data row's rows through ``_pipelined``."""
    expect_axis(mesh, "stage")
    if mesh.shape["stage"] == 1:
        return run(stacked, x, *aux)
    layers = _stage_layers(stacked, mesh)  # JAX's refusal comes before the batch's
    (y,) = over_data(mesh, lambda p, xx, *a: (_pipelined(p, xx, a, run, mesh,
                                                         num_microbatches),),
                     layers, x, *aux)
    return y


def pipeline_encoder_stack(
    stacked_params: Params,
    x: Tensor,
    bias: Optional[Tensor],
    num_heads: int,
    activation: str,
    mesh: Mesh,
    norm_order: str = "pre",
    num_microbatches: Optional[int] = None,
    remat: bool = False,
) -> Tensor:
    """``encoder_stack`` with its L layers pipelined over the mesh's stage
    axis (GPipe, microbatched over the batch). ``stacked_params`` is the
    whole stacked tree or ``pipeline_shard_params``'s slice of it; L must
    divide by the stage count, the batch by ``data`` and the local batch by
    ``num_microbatches`` (default: the smaller of the stage count and the
    local batch). Every rank passes the global ``x`` [B, S, D] and gets the
    global output. Each stage runs the plain stack on its microbatches, so
    the result equals the plain stack run microbatch by microbatch, bit for
    bit; a microbatch may fall under a kernel gate that the whole batch
    passes (``nn.transformer``), which changes the bits, not the function."""

    def run(layers: Params, h: Tensor, b: Optional[Tensor]) -> Tensor:
        return encoder_stack(layers, h, b, num_heads, activation, norm_order, remat=remat)

    return _stack_over(mesh, stacked_params, x, (bias,), run, num_microbatches)


def pipeline_conformer_stack(
    stacked_params: Params,
    x: Tensor,
    attn_bias: Optional[Tensor],
    pad_mask: Optional[Tensor],
    cfg: Any,
    mesh: Mesh,
    num_microbatches: Optional[int] = None,
    remat: bool = False,
) -> Tensor:
    """``nn.conformer.conformer_stack`` pipelined over the stage axis as
    ``pipeline_encoder_stack`` pipelines the text stack; the bias and the
    padding mask are microbatched beside x."""
    from sonar_tpu_torch.nn.conformer import conformer_stack

    def run(layers: Params, h: Tensor, b: Optional[Tensor], mk: Optional[Tensor]) -> Tensor:
        return conformer_stack(layers, h, b, mk, cfg, remat=remat)

    return _stack_over(mesh, stacked_params, x, (attn_bias, pad_mask), run, num_microbatches)


def _rows_stack(mesh: Mesh, run: Callable[..., Tensor],
                num_microbatches: Optional[int]) -> Callable[..., Tensor]:
    """A model's ``stack_fn`` on rows that are already the data row's."""
    if mesh.shape["stage"] == 1:
        return run
    return lambda stacked, x, *aux: _pipelined(_stage_layers(stacked, mesh), x, aux, run, mesh,
                                               num_microbatches)


def pipeline_text_encode(model: Any, params: Params, seqs: Tensor,
                         seq_lens: Optional[Tensor] = None, *, mesh: Mesh,
                         num_microbatches: Optional[int] = None) -> Tensor:
    """A ``SonarTextEncoder``'s sentence embeddings [B, D] with its layer
    stack pipelined over the mesh's stage axis; the frontend, the final
    LayerNorms and the pooler run on the rank's data rows. ``params`` is the
    whole tree or ``pipeline_shard_params``'s; every rank passes the global
    batch and gets every row's embedding."""
    expect_axis(mesh, "stage")
    cfg = model.config

    def run(layers: Params, h: Tensor, b: Optional[Tensor]) -> Tensor:
        return encoder_stack(layers, h, b, cfg.num_encoder_attn_heads, cfg.activation_fn,
                             "pre")

    stack_fn = _rows_stack(mesh, run, num_microbatches)
    (emb,) = over_data(mesh, lambda p, s, n: (model.forward_with(
        p, s, n, stack_fn=stack_fn).sentence_embeddings,), params, seqs, seq_lens)
    return emb


def pipeline_speech_encode(model: Any, params: Params, fbank: Tensor,
                           frame_lens: Optional[Tensor] = None, *, mesh: Mesh,
                           num_microbatches: Optional[int] = None) -> SonarEncoderOutput:
    """A ``SonarSpeechEncoder``'s output with its Conformer stack pipelined
    over the mesh's stage axis; the frontend, the LayerNorm and the
    attention pooler run on the rank's data rows. Every rank passes the
    global batch and gets the whole ``SonarEncoderOutput``."""
    from sonar_tpu_torch.nn.conformer import conformer_stack

    expect_axis(mesh, "stage")
    cfg = model.config.conformer

    def run(layers: Params, h: Tensor, b: Optional[Tensor], mk: Optional[Tensor]) -> Tensor:
        return conformer_stack(layers, h, b, mk, cfg)

    return encode_over_data(mesh, model, params, fbank, frame_lens,
                            _rows_stack(mesh, run, num_microbatches))


def encode_over_data(mesh: Mesh, model: Any, params: Params, fbank: Tensor,
                     frame_lens: Optional[Tensor], stack_fn: Callable) -> SonarEncoderOutput:
    """A speech encoder's ``forward_with(..., stack_fn=)`` on this rank's
    data rows, every field gathered over the data group."""
    if frame_lens is None:
        frame_lens = torch.full((fbank.shape[0],), fbank.shape[1], dtype=torch.int32,
                                device=fbank.device)

    def local(p: Params, f: Tensor, n: Tensor) -> Tuple[Tensor, ...]:
        out = model.forward_with(p, f, n, stack_fn=stack_fn)
        return out.encoded_seqs, out.sentence_embeddings, out.seq_lens

    encoded, emb, lens = over_data(mesh, local, params, fbank, frame_lens)
    return SonarEncoderOutput(encoded_seqs=encoded, sentence_embeddings=emb, seq_lens=lens)
