from sonar_tpu_torch.models.sonar_text.config import (  # noqa: F401
    NLLB_VOCAB,
    SonarTextEncoderConfig,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.models.sonar_text.model import SonarTextEncoder  # noqa: F401
