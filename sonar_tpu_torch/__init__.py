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
``LaserLstmEncoder``).
"""

__version__ = "0.1.0"

_PIPELINES = {
    "TextToEmbeddingModelPipeline": "text",
    "TorchTextEncoder": "text",
    "TextToTextModelPipeline": "text",
    "EmbeddingToTextModelPipeline": "text",
    "SpeechToEmbeddingModelPipeline": "speech",
    "SpeechToEmbeddingPipeline": "speech",
    "SpeechToTextModelPipeline": "speech",
    "SpeechToTextPipeline": "speech",
    "SpeechInferenceParams": "speech",
    "TorchSpeechEncoder": "speech",
    "MutoxSpeechClassifierPipeline": "mutox_speech",
}
_MODULES = {  # other lazy exports: name -> module
    "TorchTextDecoder": "generation.decoder_runtime",
    "TopPSampler": "generation.sampling",
    "TopKSampler": "generation.sampling",
    "BlaserModel": "models.blaser",
    "MutoxClassifier": "models.mutox",
    "LaserLstmEncoder": "models.laser2_text",
    "Laser2Tokenizer": "tokenizers.laser2",
}


def __getattr__(name):
    """Lazy imports keep ``import sonar_tpu_torch`` light."""
    import importlib

    if name in _PIPELINES:
        module = importlib.import_module(f"sonar_tpu_torch.inference_pipelines.{_PIPELINES[name]}")
        return getattr(module, name)
    if name in _MODULES:
        return getattr(importlib.import_module(f"sonar_tpu_torch.{_MODULES[name]}"), name)
    raise AttributeError(f"module 'sonar_tpu_torch' has no attribute {name!r}")
