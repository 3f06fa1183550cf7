"""The Conformer half-FFN kernel's plain version against the JAX kernel.

``fused_bf16_ffn_ln_residual_plain`` (the function the CUDA kernel
``csrc/bf16_ffn.cu`` computes, and the CPU path of its wrapper) against
``sonar_tpu.ops.pallas.ffn.fused_bf16_ffn_ln_residual`` in Pallas interpret
mode, on the JAX test's shape (M 300, D 128, F 512, a ragged M for its
block of 128 rows) with 1, 2 and 4 splits of F. Inputs from a numpy seed.

Tolerances: fp32 atol 2e-4, the JAX test's own (two frameworks summing the
products in another order); bf16 max-abs within 2 bf16 ulps of the
output's largest value (a bf16 rounding of the inner activation or of the
output may flip between the two).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.ops.pallas.ffn import fused_bf16_ffn_ln_residual as jax_ffn  # noqa: E402
from sonar_tpu_torch.nn import conformer  # noqa: E402
from sonar_tpu_torch.nn.core import layer_norm  # noqa: E402
from sonar_tpu_torch.ops.cuda import ffn  # noqa: E402

M, D, F = 300, 128, 512
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    return (n(M, D), 1 + n(D, s=0.1), n(D, s=0.1), n(D, F, s=0.05), n(F, s=0.1),
            n(F, D, s=0.05), n(D, s=0.1))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_splits", [1, 2, 4])
def test_plain_matches_the_pallas_kernel(dtype, n_splits):
    tdt, jdt = DT[dtype]
    args = _inputs()
    x = args[0]
    got = ffn.fused_bf16_ffn_ln_residual_plain(
        torch.tensor(x).to(tdt), *(torch.tensor(a) for a in args[1:]), n_splits=n_splits)
    want = jax_ffn(jnp.asarray(x, jdt), *(jnp.asarray(a) for a in args[1:]),
                   block_m=128, n_splits=n_splits, interpret=True)
    assert got.dtype == tdt and got.shape == (M, D)
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        assert np.abs(got - want).max() <= 2 * _bf16_ulp(np.abs(want).max())


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """On a CPU tensor the wrapper is its plain version and counts no launch."""
    args = [torch.tensor(a) for a in _inputs(1)]
    before = ffn.BF16_LAUNCHES
    got = ffn.fused_bf16_ffn_ln_residual(*args, res_scale=0.5, n_splits=2)
    assert ffn.BF16_LAUNCHES == before
    assert torch.equal(got, ffn.fused_bf16_ffn_ln_residual_plain(*args, 0.5, 2))


def test_splits_round_apart_from_the_conformer_branch():
    """The kernel's function sums fp32 split partials; the Conformer's eager
    branch (``nn.conformer._half_ffn``, which no kernel replaces) rounds
    each product to the model dtype. In fp32 the two agree; in bf16 they
    differ by roundings, not by the function."""
    x, s, b, w1, b1, w2, b2 = (torch.tensor(a) for a in _inputs(2))
    params = {"inner_proj": {"kernel": w1, "bias": b1}, "output_proj": {"kernel": w2, "bias": b2}}
    for dt, atol in ((torch.float32, 2e-4), (torch.bfloat16, 0.1)):
        xd = x.to(dt)
        branch = xd + 0.5 * conformer._half_ffn(
            {k: {n: t.to(dt) for n, t in v.items()} for k, v in params.items()},
            layer_norm({"weight": s, "bias": b}, xd))
        fused = ffn.fused_bf16_ffn_ln_residual_plain(xd, s, b, w1, b1, w2, b2)
        np.testing.assert_allclose(fused.float().numpy(), branch.float().numpy(), atol=atol)
