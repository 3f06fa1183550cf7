from sonar_tpu_torch.models.nllb_moe.config import (  # noqa: F401
    NllbMoeConfig,
    nllb_moe_archs,
)
from sonar_tpu_torch.models.nllb_moe.model import NllbMoeModel, SequenceMemory  # noqa: F401
