"""sonar_tpu_torch: the PyTorch + CUDA port of sonar_tpu.

The JAX package ``sonar_tpu`` is the reference; this package computes the
same functions with PyTorch tensors, and replaces each Pallas kernel on the
text -> embedding and speech -> embedding paths with a CUDA C++ kernel
written for Hopper (sm_90a, ``csrc/``). On CPU tensors every kernel wrapper runs its plain PyTorch
version, so the whole path runs (and is tested) without a GPU.

Host-side code that never touched JAX (``sonar_tpu.data``,
``sonar_tpu.tokenizers.spm``, ``sonar_tpu.native``) is reused as it is; this
package imports nothing that imports ``jax``.

Public entry points mirror ``sonar_tpu``'s:
``TextToEmbeddingModelPipeline(encoder, tokenizer).predict(...)`` and
``SpeechToEmbeddingModelPipeline(encoder).predict(waveforms)``.
"""

__version__ = "0.1.0"

_PIPELINES = {
    "TextToEmbeddingModelPipeline": "text",
    "TorchTextEncoder": "text",
    "SpeechToEmbeddingModelPipeline": "speech",
    "SpeechToEmbeddingPipeline": "speech",
    "SpeechInferenceParams": "speech",
    "TorchSpeechEncoder": "speech",
}


def __getattr__(name):
    """Lazy imports keep ``import sonar_tpu_torch`` light."""
    if name in _PIPELINES:
        import importlib

        module = importlib.import_module(f"sonar_tpu_torch.inference_pipelines.{_PIPELINES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'sonar_tpu_torch' has no attribute {name!r}")
