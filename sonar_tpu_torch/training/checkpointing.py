"""Training checkpoints (``sonar_tpu.training.checkpointing``): the
parameters, the optimizer's state and the step in one ``torch.save`` file.

The JAX package checkpoints with Orbax; the port writes
``{"params", "optimizer", "step"}`` and reads it back with
``torch.load(weights_only=True)`` into a template state's own tensors, in
place, so that the template's optimizer keeps stepping them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

from sonar_tpu_torch.nn.core import Params
from sonar_tpu_torch.training.train_step import TrainState
import torch


def _detached(tree: Params) -> Dict[str, Any]:
    return {k: _detached(v) if isinstance(v, dict) else v.detach() for k, v in tree.items()}


def save_train_state(path: Union[str, Path], state: TrainState) -> None:
    torch.save({"params": _detached(state.params),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, Path(path))


def _copy_into(template: Params, saved: Params, prefix: str = "") -> None:
    if set(template) != set(saved):
        raise ValueError(f"checkpoint keys under '{prefix}' differ from the template's: "
                         f"{sorted(set(template) ^ set(saved))}")
    for key, value in template.items():
        if isinstance(value, dict):
            _copy_into(value, saved[key], f"{prefix}/{key}")
        elif value.shape != saved[key].shape:
            raise ValueError(f"checkpoint leaf '{prefix}/{key}' has shape "
                             f"{tuple(saved[key].shape)}, the template {tuple(value.shape)}")
        else:
            value.copy_(saved[key])


def restore_train_state(path: Union[str, Path], template: TrainState) -> TrainState:
    """The state saved at ``path``, read into ``template``'s parameter
    tensors and optimizer (the same tree and optimizer as were saved)."""
    saved = torch.load(Path(path), map_location="cpu", weights_only=True)
    with torch.no_grad():
        _copy_into(template.params, saved["params"])
    template.optimizer.load_state_dict(saved["optimizer"])
    return TrainState(template.params, template.optimizer, int(saved["step"]))
