from sonar_tpu_torch.models.laser2_text.model import (  # noqa: F401
    Laser2Config,
    LaserLstmEncoder,
    laser2_archs,
    laser2_params_from_torch,
)
from sonar_tpu_torch.tokenizers.laser2 import Laser2Tokenizer  # noqa: F401
