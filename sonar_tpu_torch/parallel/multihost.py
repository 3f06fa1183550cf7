"""Multi-process launch helpers (``sonar_tpu.parallel.multihost``).

The reference's only multi-process mechanism is communication-free dataset
sharding by (world_size, rank) (``huggingface_pipelines/dataset.py:89-90``).
The port's counterparts of the JAX package's helpers, over
``torch.distributed``:

- ``initialize()``: ``torch.distributed.init_process_group`` (a no-op in a
  single process, as ``jax.distributed.initialize`` is there);
- ``shard_for_host(items)``: this process's share of a work list;
- ``host_batch_sharding`` / ``global_batch_from_local``: the global batch
  from each process's local rows.

A Cloud TPU pod's ``TPU_WORKER_HOSTNAMES`` belongs to a TPU launcher and is
not read here; torchrun's ``WORLD_SIZE`` takes the place of JAX's
coordinator variables.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple, TypeVar

from sonar_tpu_torch.parallel.comm import Group, gather_blocks
import torch
import torch.distributed as dist

T = TypeVar("T")

# (rank, world size) variables of each launcher, first match wins.
_LAUNCHERS = (
    ("RANK", "WORLD_SIZE"),                      # torchrun
    ("SLURM_PROCID", "SLURM_NTASKS"),
    ("SLURM_PROCID", "SLURM_NPROCS"),
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"),
    ("PMI_RANK", "PMI_SIZE"),
)


def _count(var: str) -> int:
    try:
        return int(os.environ.get(var, "1"))
    except ValueError:
        return 1


def _multiprocess_cluster_env() -> bool:
    """True when the environment names a launch of more than one process
    (torchrun, SLURM, Open MPI or PMI). Presence alone is not enough: a
    single-task SLURM job exports the variables too, so the counts are
    parsed."""
    return any(_count(size) > 1 for _, size in _LAUNCHERS)


def _cluster_rank_world() -> Tuple[int, int]:
    for rank, size in _LAUNCHERS:
        if _count(size) > 1:
            return int(os.environ.get(rank, "0")), _count(size)
    return 0, 1


def initialize(init_method: Optional[str] = None, **kwargs: Any) -> None:
    """Join the process group. With ``init_method`` (``"tcp://host:port"``,
    ``"file:///path"``) or keyword arguments (``rank``, ``world_size``,
    ``backend``, ...) they go to ``init_process_group``; with neither, a
    detected multi-process launch (``_multiprocess_cluster_env``) joins
    through ``MASTER_ADDR`` / ``MASTER_PORT`` with the launcher's rank and
    size, and a single process does nothing. The backend is NCCL when a GPU
    is available, gloo otherwise."""
    if init_method is None and not kwargs:
        if not _multiprocess_cluster_env():
            return
        rank, world = _cluster_rank_world()
        kwargs = {"rank": rank, "world_size": world}
        init_method = "env://"
    kwargs.setdefault("backend", "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(init_method=init_method, **kwargs)


def _rank_world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_for_host(items: Sequence[T]) -> Sequence[T]:
    """This process's shard of ``items``: ``items[rank::world]`` (the
    reference's world/rank pattern)."""
    rank, world = _rank_world()
    return items[rank::world]


def host_batch_sharding(mesh: Any, axis: str = "data") -> Group:
    """The group whose processes' local batches, in rank order, make up the
    global batch split over the mesh axis ``axis``."""
    return mesh.group(axis)


def global_batch_from_local(mesh: Any, local_batch: Any, axis: str = "data") -> torch.Tensor:
    """The global batch on every process: each process's local rows
    (equal counts), concatenated in rank order over the axis's group."""
    return gather_blocks(torch.as_tensor(local_batch), host_batch_sharding(mesh, axis))
