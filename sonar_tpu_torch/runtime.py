"""What the port's model runtimes share.

``TorchTextEncoder``, ``TorchSpeechEncoder`` and ``TorchTextDecoder`` each
bind one model for inference on one device over a ``parallel.mesh.Mesh``,
and stand on ``ModelRuntime``: it places the weights (the int8 rewrite,
this rank's slice, the model rebuilt on the device), opens the scope a
model runs in, and gathers its rows over the mesh's data axis and copies
them out. The layers point one way: ``inference_pipelines`` ->
``generation`` -> ``runtime`` -> ``parallel``, ``ops`` and ``device``.

Beside it, the rules that pad a global batch before it is split over the
data axis (``split_rows``), the runtimes' thread-safe counters
(``Counters``), the one dispatch-ahead window (``stream_in_window``) and the
one restore of the input order (``restore``).
"""

from __future__ import annotations

from collections import deque
import contextlib
import threading
from typing import Any, Callable, Deque, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
from sonar_tpu_torch.data.collate import round_up_pow2
from sonar_tpu_torch.device import resolve_device
from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.ops.precision import matmul_precision_for
from sonar_tpu_torch.ops.quantization import quantize_params_int8
from sonar_tpu_torch.parallel.comm import gather_blocks, model_parallel
from sonar_tpu_torch.parallel.mesh import SINGLE_MESH, Mesh, data_sharding, pad_rows, shard_params
from sonar_tpu_torch.utils.profiling import span
import torch

# How a runtime pads a global batch before splitting it over the data axis,
# as the JAX runtimes do. The text encoder: to a multiple of ``data``.
ENCODER_ROWS = "encoder"
# Speech, beam search and sampling: to a power of two, then a multiple of
# ``data``.
POW2_ROWS = "pow2"
# Teacher-forced scoring: as ``POW2_ROWS``, but left as it is under
# ``data == 1``.
SCORE_ROWS = "score"


def row_split(rows: int, mesh: Mesh, rule: str) -> Tuple[int, slice]:
    """(the padded row count, this rank's rows of it) of a global batch of
    ``rows`` under ``rule``."""
    if rule == ENCODER_ROWS or (rule == SCORE_ROWS and mesh.data == 1):
        padded = pad_rows(rows, mesh)
    else:
        padded = pad_rows(round_up_pow2(rows), mesh)
    return padded, data_sharding(mesh, padded)


def split_rows(x: Any, mesh: Mesh, rule: str, fill: int = 0) -> Any:
    """This rank's rows of the global batch ``x`` (a numpy array or a
    tensor, rows first), padded with rows of ``fill`` under ``rule``
    (``row_split``); ``x`` itself under ``data == 1`` when no row is
    added."""
    padded, mine = row_split(x.shape[0], mesh, rule)
    pad = padded - x.shape[0]
    if pad and torch.is_tensor(x):
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    elif pad:
        x = np.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1), constant_values=fill)
    return x if mesh.data == 1 else x[mine]


class ModelRuntime:
    """A model bound for inference on one device (``device=None`` means the
    GPU) over ``mesh`` (``SINGLE_MESH``, this process alone, when None).

    ``params`` is the model's weight tree after the subclass's own rewrites;
    ``quantize`` stores its linear weights as int8 with per-output-channel
    scales, this rank keeps its slice (``shard_params``), and ``self.model``
    is the model rebuilt from them on the device."""

    def __init__(self, model: Any, params: Params, quantize: bool, device: Any,
                 mesh: Optional[Mesh]):
        self.device = resolve_device(device)
        self.mesh = SINGLE_MESH if mesh is None else mesh
        if quantize:
            params = quantize_params_int8(params)
        params = shard_params(params, self.mesh)
        self.model = type(model)(model.config, params, dtype=model.dtype).to(self.device)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def model_dim(self) -> int:
        return self.model.config.model_dim

    @contextlib.contextmanager
    def scope(self) -> Iterator[None]:
        """The scope the model runs in: inference mode, the matmul precision
        of its dtype and the tensor parallelism of the mesh's model group."""
        with torch.inference_mode(), matmul_precision_for(self.dtype), \
                model_parallel(self.mesh.model_group):
            yield

    def gather(self, out: torch.Tensor, rows: int) -> torch.Tensor:
        """Every data rank's rows of ``out`` in row order, the first
        ``rows`` (``out`` itself when that is all of them: a slice is one
        more op to dispatch a batch)."""
        out = gather_blocks(out, self.mesh.data_group)
        return out if out.shape[0] == rows else out[:rows]

    @staticmethod
    def to_host(out: torch.Tensor) -> np.ndarray:
        """``out`` as fp32 numpy, under the ``runtime.copy_out`` span."""
        with span("runtime.copy_out", rows=out.shape[0]):
            return out.float().cpu().numpy()


class Counters:
    """Thread-safe integer counts by name, over every call of a runtime.
    ``snapshot()`` adds ``padding_waste``: 1 - true / padded of the pair of
    counts named ``true`` and ``padded``."""

    def __init__(self, *names: str, true: str, padded: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)
        self._pair = true, padded

    def add(self, **counts: int) -> None:
        with self._lock:
            for name, n in counts.items():
                self._counts[name] += int(n)

    def snapshot(self) -> dict:
        with self._lock:
            out = dict(self._counts)
        true, padded = (out[name] for name in self._pair)
        out["padding_waste"] = round(1.0 - true / padded, 4) if padded else 0.0
        return out


def stream_in_window(handles: Iterable[Any], finish: Callable[[Any], Any],
                     window: int = 2) -> Iterator[Any]:
    """``finish`` of each handle, in order, keeping up to ``window``
    dispatched beyond the one being finished: the dispatch of batch i + 1
    (pulled from ``handles``) runs before batch i is finished."""
    pending: Deque[Any] = deque()
    for handle in handles:
        pending.append(handle)
        if len(pending) > window:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())


def restore(parts: Sequence[np.ndarray], order: Optional[np.ndarray]) -> np.ndarray:
    """The batches' rows ``parts`` concatenated, in input order: ``order``
    holds the input position of each concatenated row (None: they are in
    input order already)."""
    out = np.concatenate(parts, axis=0)
    return out if order is None else out[np.argsort(order, kind="stable")]
