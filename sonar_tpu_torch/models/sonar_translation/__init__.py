from sonar_tpu_torch.models.sonar_translation.model import (  # noqa: F401
    DummyEncoderModel,
    SonarEncoderDecoderModel,
    create_sonar_speech_to_text_model,
    create_sonar_text_encoder_decoder_model,
)
