"""Tensor ops of the port: masks, attention, int8 quantisation, precision
policy, the kernel gates' settings, and the CUDA kernels (``ops.cuda``).

Exports the counterparts of ``sonar_tpu.ops``'s names, resolved on first use
(so that no import builds a kernel). ``sdpa_xla`` maps to the port's plain
``sdpa`` (exported under both names). The kernel-selection API
(``gates``) is the JAX package's under CUDA names, since the port has no
TPU kernels:

- ``no_cuda_kernels`` is ``no_tpu_kernels`` (a scope that turns every
  kernel gate off; it nests and stays in its thread),
  ``cuda_kernels_disabled`` is ``tpu_kernels_disabled``, and
  ``kernel_gate_scope`` keeps its name;
- ``set_attention_impl`` takes ``"auto" | "plain" | "cuda"`` for JAX's
  ``"auto" | "xla" | "pallas"``, and ``set_ffn_impl`` (JAX's
  ``sonar_tpu.nn.transformer.set_ffn_impl``) ``"auto" | "plain"`` for
  ``"auto" | "xla"``;
- the port's own: ``kernels_allowed``, the one predicate every kernel gate
  calls (no scope, and nothing that autograd records: ``records_grad``,
  since the kernels have no backward), and ``kernel_settings``, what a
  captured decode keys on.

Three names have no counterpart: ``kernels_off_for`` (JAX turns its
kernels off under a mesh, where GSPMD cannot partition a Pallas call; the
port keeps its kernels under a mesh, each rank running them on its own
heads, so the function would only repeat ``cuda_kernels_disabled``),
``waveform_to_fbank`` (the port computes fbanks in batches,
``batched_fbank``) and ``causal_mask`` (the port's decoders build their
masks in place).
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "dispatch_sdpa": "attention",
    "sdpa": "attention",
    "sdpa_xla": "attention:sdpa",
    "set_attention_impl": "attention",
    "FbankConfig": "fbank",
    "batched_fbank": "fbank",
    "cuda_kernels_disabled": "gates",
    "kernel_gate_scope": "gates",
    "kernel_settings": "gates",
    "kernels_allowed": "gates",
    "no_cuda_kernels": "gates",
    "records_grad": "gates",
    "set_ffn_impl": "gates",
    "additive_bias": "masks",
    "length_mask": "masks",
    "quantize_params_int8": "quantization",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
