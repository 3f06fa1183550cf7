"""Scale-out over ``torch.distributed`` (``sonar_tpu.parallel``), resolved
on first use:

- ``mesh``: the (data, model) ``Mesh`` of the ranks, the tensor-parallel
  split rules and ``shard_params``;
- ``comm``: the collectives and the two tensor-parallel autograd operators;
- ``mining``: cosine top-k, xsim / xsim++ and bitext mining, on one device
  or with the bank split over a mesh axis;
- ``multihost``: joining the process group and assembling a global batch;
- ``pipeline``: GPipe over the text and Conformer stacks on a (data, stage)
  mesh, the stage-to-stage transfers over two-rank groups;
- ``sequence``: the Conformer with its time axis split over a (data, seq)
  mesh, K and V gathered and the depthwise convolution's halo exchanged.

The pipeline and sequence functions are differentiable: every rank passes
the global input and gets the global output, and a loss that every rank
computes alike leaves each with the single-device gradients of what it
holds. Neither is wired into ``training.make_train_step``, as in JAX.
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    **{name: "mining" for name in (
        "l2_normalize", "cosine_topk", "xsim", "xsim_pp", "mine_bitexts",
        "sharded_cosine_topk", "sharded_xsim", "sharded_xsim_pp")},
    **{name: "mesh" for name in (
        "Mesh", "SINGLE_MESH", "make_mesh", "param_shardings", "shard_params",
        "replicate", "data_sharding")},
    **{name: "multihost" for name in (
        "initialize", "shard_for_host", "host_batch_sharding", "global_batch_from_local")},
    **{name: "pipeline" for name in (
        "make_pipeline_mesh", "pipeline_param_shardings", "pipeline_shard_params",
        "pipeline_encoder_stack",
        "pipeline_conformer_stack", "pipeline_text_encode", "pipeline_speech_encode")},
    **{name: "sequence" for name in (
        "make_seq_mesh", "sequence_conformer_stack", "sequence_speech_encode")},
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
