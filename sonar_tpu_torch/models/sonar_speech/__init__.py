from sonar_tpu_torch.models.sonar_speech.config import (  # noqa: F401
    SonarSpeechEncoderConfig,
    W2VBertFrontendConfig,
    sonar_speech_encoder_archs,
)
from sonar_tpu_torch.models.sonar_speech.model import SonarSpeechEncoder  # noqa: F401
