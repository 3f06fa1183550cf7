"""A device-side loop over a captured CUDA graph (``csrc/graph_loop.cu``).

``WhileGraph(body, done)`` wraps ``body``, a ``torch.cuda.CUDAGraph``
captured with ``keep_graph=True``, in a CUDA graph conditional WHILE node:
one ``launch`` replays the body until it writes True into ``done`` (a 0-d
bool tensor on the card), with the exit test on the device, as JAX's
``lax.while_loop`` runs. The host reads nothing while the loop runs.

This is the runtime's loop, not a port of a TPU kernel: it has no plain
version and runs on a card only.
"""

from __future__ import annotations

import ctypes
from typing import Any

from sonar_tpu_torch.ops import _build
import torch


class WhileGraph:
    """The loop graph, instantiated; ``body`` (and the memory pool its
    kernels use) must outlive it, so it keeps a reference."""

    def __init__(self, body: Any, done: torch.Tensor):
        if not (done.is_cuda and done.dtype == torch.bool and done.dim() == 0):
            raise ValueError("done must be a 0-d bool tensor on a CUDA device")
        self.body, self.done = body, done
        exec_ = ctypes.c_void_p()
        _build.check(_build.library().sonar_graph_while(body.raw_cuda_graph(), done.data_ptr(),
                                                        ctypes.byref(exec_)),
                     "graph_loop while node")
        self._exec = exec_.value

    def launch(self, stream: Any) -> None:
        """Run the loop on ``stream`` (a ``torch.cuda.Stream``)."""
        _build.check(_build.library().sonar_graph_launch(self._exec, stream.cuda_stream),
                     "graph_loop launch")

    def __del__(self) -> None:
        if getattr(self, "_exec", None):
            _build.library().sonar_graph_exec_destroy(self._exec)
            self._exec = None
