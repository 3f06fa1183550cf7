"""sonar_tpu_torch: the PyTorch + CUDA port of sonar_tpu.

The JAX package ``sonar_tpu`` is the reference; this package computes the
same functions with PyTorch tensors, and replaces each Pallas kernel on the
text -> embedding path with a CUDA C++ kernel written for Hopper (sm_90a,
``csrc/``). On CPU tensors every kernel wrapper runs its plain PyTorch
version, so the whole path runs (and is tested) without a GPU.

Host-side code that never touched JAX (``sonar_tpu.data``,
``sonar_tpu.tokenizers.spm``, ``sonar_tpu.native``) is reused as it is; this
package imports nothing that imports ``jax``.

Public entry points mirror ``sonar_tpu``'s:
``TextToEmbeddingModelPipeline(encoder, tokenizer).predict(...)``.
"""

__version__ = "0.1.0"

_PIPELINES = ("TextToEmbeddingModelPipeline", "TorchTextEncoder")


def __getattr__(name):
    """Lazy imports keep ``import sonar_tpu_torch`` light."""
    if name in _PIPELINES:
        import sonar_tpu_torch.inference_pipelines.text as _t

        return getattr(_t, name)
    raise AttributeError(f"module 'sonar_tpu_torch' has no attribute {name!r}")
