"""Inference pipelines of the port, under the names ``sonar_tpu.inference_pipelines``
exports. Resolved on first use, so that importing the package loads no model code."""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "TextToEmbeddingModelPipeline": "text",
    "TextToTextModelPipeline": "text",
    "EmbeddingToTextModelPipeline": "text",
    "TorchTextEncoder": "text",
    "SpeechInferenceParams": "speech",
    "SpeechToEmbeddingModelPipeline": "speech",
    "SpeechToEmbeddingPipeline": "speech",
    "SpeechToTextModelPipeline": "speech",
    "SpeechToTextPipeline": "speech",
    "TorchSpeechEncoder": "speech",
    "MutoxSpeechClassifierPipeline": "mutox_speech",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
