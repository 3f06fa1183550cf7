"""The (data, model) mesh over ``torch.distributed`` and the tensor-parallel
split of a parameter tree (``sonar_tpu.parallel.mesh``).

A ``Mesh`` names a ``(data, model)`` grid over the ranks of the default
process group, rank = d * model + m (the order of JAX's
``np.reshape(devices, (data, model))``), and holds this rank's coordinates
and its two subgroups: ``data_group`` (the ranks of its model column, which
hold the same weights and different rows) and ``model_group`` (the ranks of
its data row, which hold the same rows and different slices of the weights).

The second axis carries a name: ``model`` (``make_mesh``, tensor
parallelism: the runtimes, the train step and ``shard_params`` take only
this one), ``stage`` (``parallel.pipeline.make_pipeline_mesh``, whose mesh
also holds the two-rank groups that link each stage to its neighbours) or
``seq`` (``parallel.sequence.make_seq_mesh``), in the same rank order;
``mesh.group(name)`` is its group either way, and ``expect_axis`` refuses a
mesh of another kind.

The split rules are the JAX package's (``_spec_for_path``), with its
fallback to a whole copy when a dimension does not divide:

- column-parallel (q/k/v/inner projections): the output axis is split, and
  with it the bias and, for int8 weights, the per-column scale (which the
  JAX package keeps whole: GSPMD slices it for the product, a rank here
  must hold its own columns);
- row-parallel (``output_proj``): the input axis; the bias is added once,
  after the sum over the model group;
- ``embed/weight``: the vocabulary axis.

The one change to the rules themselves: the fused ``qkv_proj`` [D, 3D] is
split head-aligned, q, k and v each in ``model`` column blocks, so a rank
holds the q | k | v columns of its own H / model heads. (JAX's rule splits
the fused axis in contiguous blocks, which GSPMD can run and a rank that
computes its attention alone cannot.)

A rank computes its heads, FFN columns and vocabulary rows alone, so an
attention or FFN pair that does not divide cannot be kept whole on every
rank: the layers could not tell it from a split one by its shapes.
``shard_params`` raises there (every SONAR architecture divides by 2 and 4).
A vocabulary that does not divide (NLLB's 256,206 at model 4) is kept
whole, as in JAX: the frontends and the tied projection know the full size.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from sonar_tpu_torch.ops.quantization import column_major, is_column_major
from sonar_tpu_torch.parallel.comm import SINGLE, Group, broadcast_from
import torch
import torch.distributed as dist

Spec = Tuple[Any, ...]
_COLUMN = ("q_proj", "k_proj", "v_proj", "inner_proj", "qkv_proj")
_ROW = ("output_proj",)


@dataclass(frozen=True)
class Mesh:
    """A (data, ``axis``) grid over the world; ``rank`` is the global rank
    and ``data_index`` / ``model_index`` its coordinates. ``model`` is the
    size of the second axis, whatever its name; ``links`` are a pipeline
    mesh's groups of this rank with the previous and the next stage (None at
    either end, and on other meshes)."""

    data: int
    model: int
    rank: int
    data_group: Group
    model_group: Group
    world: Group
    axis: str = "model"
    links: Tuple[Optional[Group], Optional[Group]] = (None, None)

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size by name (JAX's ``Mesh.shape``)."""
        return {"data": self.data, self.axis: self.model}

    def group(self, axis: str) -> Group:
        if axis not in ("data", self.axis):
            raise ValueError(f"unknown mesh axis: {axis!r}")
        return self.data_group if axis == "data" else self.model_group


# The mesh of one process alone: the runtimes and the train step given no
# mesh run on it (every group of one rank, so no collective is issued).
SINGLE_MESH = Mesh(data=1, model=1, rank=0, data_group=SINGLE, model_group=SINGLE, world=SINGLE)


def expect_axis(mesh: Mesh, axis: str) -> None:
    """Raise ``ValueError`` unless ``mesh``'s second axis is ``axis``: a
    runtime's ``mesh=`` takes a (data, model) mesh, the pipeline functions a
    (data, stage) one and the sequence-parallel ones a (data, seq) one."""
    if mesh.axis != axis:
        raise ValueError(f"this function takes a (data, {axis}) mesh, not a "
                         f"(data, {mesh.axis}) one")


def _group(ranks: Tuple[int, ...], rank: int, pgs: Dict[Tuple[int, ...], Any]) -> Group:
    return Group(pgs.get(ranks), ranks, ranks.index(rank))


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The mesh over the initialized default process group (``data=-1``:
    every rank not taken by ``model``). Without a process group the world is
    this one process, and only a 1 x 1 mesh exists. Every rank must call it,
    in the same order as its other group creations."""
    return make_axis_mesh("model", model, data)


def make_axis_mesh(axis: str, size: int, data: int = -1) -> Mesh:
    """``make_mesh`` with the second axis named ``axis`` (``model``,
    ``stage`` or ``seq``) of ``size`` ranks. A ``stage`` mesh also creates
    the two-rank group of each pair of neighbouring stages."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if size < 1 or world % size:
        raise ValueError(f"{axis}={size} does not divide the world of {world} ranks")
    if data == -1:
        data = world // size
    if data * size != world:
        raise ValueError(
            f"a {data} x {size} mesh needs {data * size} ranks, the world has {world}"
            + ("" if world > 1 else ": initialize a process group first "
               "(parallel.multihost.initialize)"))
    columns = [tuple(d * size + m for d in range(data)) for m in range(size)]
    rows = [tuple(d * size + m for m in range(size)) for d in range(data)]
    pairs = [row[i:i + 2] for row in rows for i in range(size - 1)] if axis == "stage" else []
    pgs: Dict[Tuple[int, ...], Any] = {}
    if world > 1:
        # new_group is collective: every rank creates every group, in order.
        for ranks in columns + rows + pairs:
            if len(ranks) > 1 and ranks not in pgs:
                pgs[ranks] = dist.new_group(list(ranks))
        pgs[tuple(range(world))] = dist.group.WORLD
    mine = rank % size, rank // size
    links = tuple(_group(pair, rank, pgs) if pair in pairs else None
                  for pair in ((rank - 1, rank), (rank, rank + 1)))
    return Mesh(
        data=data, model=size, rank=rank,
        data_group=_group(columns[mine[0]], rank, pgs),
        model_group=_group(rows[mine[1]], rank, pgs),
        world=_group(tuple(range(world)), rank, pgs) if world > 1 else SINGLE,
        axis=axis, links=links,
    )


# -- parameter split rules ---------------------------------------------------
#
# Layer-stacked leaves carry a leading L axis: kernels are [L, in, out] and
# biases [L, out]; frontend embeddings are [V, D].


def _spec_for_path(path: str, ndim: int) -> Spec:
    """The split of one leaf as a tuple over its axes: "model" on the split
    axis, None elsewhere; ``()`` keeps the leaf whole."""

    def last_axes(*axes: Any) -> Spec:
        return tuple([None] * (ndim - len(axes)) + list(axes))

    parts = path.split("/")
    owner, leaf = (parts[-2], parts[-1]) if len(parts) > 1 else ("", parts[-1])
    if owner in _COLUMN:
        if leaf in ("kernel", "kernel_q"):
            return last_axes(None, "model")
        if leaf in ("bias", "scale"):
            return last_axes("model")
    if owner in _ROW and leaf in ("kernel", "kernel_q"):
        return last_axes("model", None)
    if path.endswith("embed/weight") and ndim == 2:
        return ("model", None)
    return ()


def _walk(tree: Dict[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            yield from _walk(value, path)
        else:
            yield path, value


def _map(tree: Dict[str, Any], fn, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        out[key] = _map(value, fn, path) if isinstance(value, dict) else fn(path, value)
    return out


def _divides(path: str, shape: Tuple[int, ...], spec: Spec, n: int) -> bool:
    fused = path.split("/")[-2:-1] == ["qkv_proj"]
    return all(axis is None or shape[d] % (3 * n if fused else n) == 0
               for d, axis in enumerate(spec))


def param_shardings(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The tree of split specs (``_spec_for_path``), a leaf whose split axis
    does not divide by ``mesh.model`` kept whole (``()``)."""

    def spec(path: str, leaf: torch.Tensor) -> Spec:
        s = _spec_for_path(path, len(leaf.shape))
        return s if _divides(path, tuple(leaf.shape), s, mesh.model) else ()

    return _map(params, spec)


def _own(piece: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A copy of ``piece`` that holds no reference to ``like``'s storage, in
    ``like``'s layout (int8 kernels stay column-major)."""
    piece = piece.clone(memory_format=torch.contiguous_format)
    return column_major(piece) if like.dtype == torch.int8 and is_column_major(like) else piece


def _local(path: str, leaf: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    if not spec:
        return leaf
    dim = spec.index("model")
    m, n = mesh.model_index, mesh.model
    if path.split("/")[-2] == "qkv_proj":
        third = leaf.shape[dim] // 3
        width = third // n
        piece = torch.cat([leaf.narrow(dim, j * third + m * width, width) for j in range(3)],
                          dim=dim)
    else:
        width = leaf.shape[dim] // n
        piece = leaf.narrow(dim, m * width, width)
    return _own(piece, leaf)


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's slice of every leaf of ``params`` (the whole tree, the same
    on every rank) under the split rules; leaves kept whole are returned as
    they are. Raises when an attention or FFN leaf does not divide, or for a
    mesh whose second axis is not ``model``."""
    expect_axis(mesh, "model")
    if mesh.model == 1:
        return params
    specs = dict(_walk(param_shardings(params, mesh)))
    for path, leaf in _walk(params):
        if (not specs[path] and _spec_for_path(path, len(leaf.shape))
                and not path.endswith("embed/weight")):
            raise ValueError(
                f"{path} {tuple(leaf.shape)} does not split over model={mesh.model}: "
                "the port splits every attention and FFN pair under model > 1")
    return _map(params, lambda path, leaf: _local(path, leaf, specs[path], mesh))


def replicate(tree: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """``tree`` with every leaf broadcast from rank 0 of the world (in
    place), so that every rank holds the same values."""
    for _, leaf in _walk(tree):
        broadcast_from(leaf, mesh.world)
    return tree


def pad_rows(rows: int, mesh: Mesh) -> int:
    """``rows`` rounded up to a multiple of the data axis (as the JAX
    runtimes pad a global batch before sharding it)."""
    return -(-rows // mesh.data) * mesh.data


def data_sharding(mesh: Mesh, rows: int) -> slice:
    """The rows of a global batch of ``rows`` that this rank owns: its data
    coordinate's equal block. Raises when ``rows`` does not divide."""
    if rows % mesh.data:
        raise ValueError(f"a batch of {rows} rows does not split over data={mesh.data}")
    per = rows // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)
