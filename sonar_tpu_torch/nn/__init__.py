"""Functional NN layers of the port over nested-dict parameter trees.

Exports the counterparts of ``sonar_tpu.nn``'s names, resolved on first use,
with ``dropout`` (the training frontends') and ``tree_leaves`` (a tree's
tensors in a fixed order). One JAX name has no counterpart:
``AttentionSpec`` (the JAX package's hashable static argument for ``jit``;
the port's layers take the head count as a plain argument).
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "ConditionalTransformerDecoder": "conditional_decoder",
    "ConformerConfig": "conformer",
    "conformer_stack": "conformer",
    "dropout": "core",
    "embedding_lookup": "core",
    "layer_norm": "core",
    "linear": "core",
    "EmbeddingFrontend": "frontend",
    "bilstm_stack": "lstm",
    "Pooling": "pooling",
    "static_pool": "pooling",
    "LearnedPositionEncoder": "position",
    "SinusoidalPositionEncoder": "position",
    "tree_leaves": "core",
    "decoder_stack": "transformer",
    "encoder_stack": "transformer",
    "fuse_qkv": "transformer",
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
