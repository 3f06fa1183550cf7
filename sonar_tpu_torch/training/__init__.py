"""Training of the port's models (``sonar_tpu.training``): the losses, the
train step and checkpoints, resolved on first use."""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "TrainState": "train_step",
    "classifier_loss": "train_step",
    "cross_entropy": "train_step",
    "distillation_loss": "train_step",
    "init_train_state": "train_step",
    "make_train_step": "train_step",
    "translation_loss": "train_step",
    "restore_train_state": "checkpointing",
    "save_train_state": "checkpointing",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
