from sonar_tpu_torch.models.mutox.model import (  # noqa: F401
    MutoxClassifier,
    MutoxConfig,
    mutox_archs,
    mutox_params_from_torch,
)
