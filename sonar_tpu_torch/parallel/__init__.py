"""Mining and the xsim / xsim++ evaluation on one device (``mining``).

The counterparts of ``sonar_tpu.parallel.mining``'s single-device
functions, resolved on first use. The JAX package's mesh parallelism
(``mesh``, ``pipeline``, ``sequence``, ``multihost``) and the sharded
mining functions are not ported yet.
"""

from sonar_tpu_torch._lazy import lazy_exports

_EXPORTS = {name: "mining" for name in (
    "l2_normalize", "cosine_topk", "xsim", "xsim_pp", "mine_bitexts")}
__all__ = sorted(_EXPORTS)
__getattr__ = lazy_exports(__name__, _EXPORTS)
