"""Scale-out over ``torch.distributed`` (``sonar_tpu.parallel``), resolved
on first use:

- ``mesh``: the (data, model) ``Mesh`` of the ranks, the tensor-parallel
  split rules and ``shard_params``;
- ``comm``: the collectives and the two tensor-parallel autograd operators;
- ``mining``: cosine top-k, xsim / xsim++ and bitext mining, on one device
  or with the bank split over a mesh axis;
- ``multihost``: joining the process group and assembling a global batch.

The JAX package's pipeline and sequence parallelism (``pipeline``,
``sequence``) are not ported yet.
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
}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
