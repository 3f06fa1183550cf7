"""Tensor ops of the port: masks, attention, int8 quantisation, precision
policy, and the CUDA kernels (``ops.cuda``).

Exports the counterparts of ``sonar_tpu.ops``'s names, resolved on first use
(so that no import builds a kernel). ``sdpa_xla`` maps to the port's plain
``sdpa`` (exported under both names). ``records_grad`` is the port's own:
the predicate every kernel gate reads to keep the kernels, which have no
backward, off tensors that autograd records (``gates``). Three names have
no counterpart:
``set_attention_impl`` (the port has one backend: ``dispatch_sdpa``'s gate
picks the CUDA kernel by shape, the wrapper picks it by device),
``waveform_to_fbank`` (the port computes fbanks in batches, ``batched_fbank``)
and ``causal_mask`` (the port's decoders build their masks in place).
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "dispatch_sdpa": "attention",
    "sdpa": "attention",
    "sdpa_xla": "attention:sdpa",
    "FbankConfig": "fbank",
    "batched_fbank": "fbank",
    "records_grad": "gates",
    "additive_bias": "masks",
    "length_mask": "masks",
    "quantize_params_int8": "quantization",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
