from sonar_tpu_torch.models.blaser.model import (  # noqa: F401
    BlaserConfig,
    BlaserModel,
    blaser_archs,
    blaser_params_from_torch,
)
