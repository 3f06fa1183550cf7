"""sonar_tpu_torch: the PyTorch + CUDA port of sonar_tpu.

The JAX package ``sonar_tpu`` is the reference; this package computes the
same functions with PyTorch tensors, and replaces each Pallas kernel with a
CUDA C++ kernel written for Hopper (sm_90a, ``csrc/``). On CPU tensors every
kernel wrapper runs its plain PyTorch version, so the whole path runs (and
is tested) without a GPU.

The package stands alone: it imports nothing of ``sonar_tpu`` and nothing
of ``jax``. It keeps its own copies of the host code it shares with the
JAX package (``data``, ``tokenizers.spm``, ``native``, the checkpoint key
maps and the asset store). Every entry point runs on the GPU unless it is
given ``device="cpu"``.

Public entry points mirror ``sonar_tpu``'s:
``TextToEmbeddingModelPipeline(encoder, tokenizer).predict(...)``,
``SpeechToEmbeddingModelPipeline(encoder).predict(waveforms)``,
``EmbeddingToTextModelPipeline(decoder, tokenizer).predict(embeddings, ...)``,
``TextToTextModelPipeline(encoder, decoder, tokenizer).predict(...)``,
``SpeechToTextModelPipeline(encoder, decoder, tokenizer).predict(...)``,
``MutoxSpeechClassifierPipeline(classifier, encoder).predict(...)``, and the
BLASER, MuTox and LASER2 heads (``BlaserModel``, ``MutoxClassifier``,
``LaserLstmEncoder``), and the asset hub's loaders (``load_text_encoder``
and the hub's other loaders). Every export is resolved on first use.
"""

__version__ = "0.1.0"

from sonar_tpu_torch._lazy import lazy_exports

_HUB = "assets.hub"  # the asset hub's loaders, as ``sonar_tpu`` exports them
_EXPORTS = {  # name -> module, relative to this package
    "TextToEmbeddingModelPipeline": "inference_pipelines.text",
    "TorchTextEncoder": "inference_pipelines.text",
    "TextToTextModelPipeline": "inference_pipelines.text",
    "EmbeddingToTextModelPipeline": "inference_pipelines.text",
    "SpeechToEmbeddingModelPipeline": "inference_pipelines.speech",
    "SpeechToEmbeddingPipeline": "inference_pipelines.speech",
    "SpeechToTextModelPipeline": "inference_pipelines.speech",
    "SpeechToTextPipeline": "inference_pipelines.speech",
    "SpeechInferenceParams": "inference_pipelines.speech",
    "TorchSpeechEncoder": "inference_pipelines.speech",
    "MutoxSpeechClassifierPipeline": "inference_pipelines.mutox_speech",
    "load_text_encoder": _HUB,
    "load_text_decoder": _HUB,
    "load_speech_encoder": _HUB,
    "load_blaser_model": _HUB,
    "load_mutox_model": _HUB,
    "load_laser2_model": _HUB,
    "load_tokenizer": _HUB,
    "get_sonar_text_encoder_hub": _HUB,
    "get_sonar_text_decoder_hub": _HUB,
    "get_sonar_speech_encoder_hub": _HUB,
    "get_text_tokenizer_hub": _HUB,
    "TorchTextDecoder": "generation.decoder_runtime",
    "TopPSampler": "generation.sampling",
    "TopKSampler": "generation.sampling",
    "BlaserModel": "models.blaser",
    "MutoxClassifier": "models.mutox",
    "LaserLstmEncoder": "models.laser2_text",
    "Laser2Tokenizer": "tokenizers.laser2",
}
# Lazy imports keep ``import sonar_tpu_torch`` light.
__getattr__ = lazy_exports(__name__, _EXPORTS)
