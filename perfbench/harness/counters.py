"""The program's own launch counters (``sonar_tpu_torch.ops.cuda``: each
kernel module counts its wrapper's launches, graph replays included), read
by name."""

from __future__ import annotations

import importlib
from typing import Dict

# counter name -> (module of sonar_tpu_torch.ops.cuda, attribute)
KERNELS = {
    "attn_block": ("attn_block", "LAUNCHES"),
    "int8_ffn": ("ffn", "LAUNCHES"),
    "flash": ("flash", "LAUNCHES"),
}


def launches() -> Dict[str, int]:
    out = {}
    for name, (module, attr) in KERNELS.items():
        mod = importlib.import_module(f"sonar_tpu_torch.ops.cuda.{module}")
        out[f"launches.{name}"] = int(getattr(mod, attr))
    return out
