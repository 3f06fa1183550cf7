"""Pipeline utilities (``sonar_tpu.inference_pipelines.utils``).

The JAX package's ``precision_context`` has its counterpart in
``sonar_tpu_torch.ops.precision.matmul_precision_for``, which every model
runtime of the port enters in its scope (``runtime.ModelRuntime.scope``).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sized


def add_progress_bar(iterable: Iterable, inputs: Optional[Sized] = None,
                     batch_size: Optional[int] = None) -> Iterable:
    """Wrap with tqdm when it is installed."""
    try:
        from tqdm.auto import tqdm
    except ImportError:
        return iterable
    total = None
    if inputs is not None and batch_size:
        try:
            total = math.ceil(len(inputs) / batch_size)
        except TypeError:
            total = None
    return tqdm(iterable, total=total)
