"""The plain versions of the port's three beam-attend kernels against the JAX
package's Pallas kernels in interpret mode, and the port's
``_beam_self_attend`` against the JAX one.

Inputs come from a numpy seed and go to both packages. Tolerances: fp32
agrees to rtol = atol = 1e-5 (the JAX kernel tests' own bound: the same
arithmetic summed in another order); bf16 kernel outputs to one bf16 ulp of
the output scale (2^-7: both round the same fp32 result, which may sit on
either side of a rounding boundary), the reordered caches exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.ops.pallas import beam_attend as jba  # noqa: E402
from sonar_tpu_torch.nn import transformer as ttr  # noqa: E402
from sonar_tpu_torch.ops.cuda import beam_attend as tba  # noqa: E402

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (b, beam, heads, s, dh): the shapes of tests/unit/test_beam_attend.py
MASKED_SHAPES = [(2, 5, 16, 11, 64), (3, 2, 4, 7, 32)]
REORDER_SHAPE = (3, 5, 4, 11, 64)
DIAG_SHAPE = (4, 5, 4, 11, 64)


def _t(a, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(DT[dtype][0])


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), DT[dtype][1])


def _vbias(s, idx):
    return np.where(np.arange(s) <= idx, 0.0, -1e30).astype(np.float32)


def _check(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MASKED_SHAPES)
def test_beam_masked_attend_plain_matches_pallas(shape, dtype):
    b, beam, heads, s, dh = shape
    rng = np.random.default_rng(3)
    q = rng.normal(size=(b * heads, beam, dh))
    k = rng.normal(size=(b * heads, beam, s, dh))
    v = rng.normal(size=(b * heads, beam, s, dh))
    anc = rng.integers(0, beam, size=(b, beam, s)).astype(np.int32)
    launches = tba.MASKED_LAUNCHES
    for idx in (0, s // 2, s - 1):
        vb = _vbias(s, idx)
        got = tba.beam_masked_attend(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                     torch.tensor(anc), torch.tensor(vb), heads)
        want = jba.beam_masked_attend(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(anc),
                                      jnp.asarray(vb), heads, interpret=True)
        assert got.dtype == DT[dtype][0]
        _check(got, want, dtype)
    assert tba.MASKED_LAUNCHES == launches  # CPU tensors take the plain version


def _tree_ancestry(rng, b, beam, s, idx):
    """[B, K, S] ancestry as beam search builds it: the identity, then at
    each step 0..idx every beam takes a random parent's table and names its
    own row at the step's position (lineages merge within a few steps)."""
    anc = np.broadcast_to(np.arange(beam, dtype=np.int32)[None, :, None], (b, beam, s)).copy()
    for t in range(idx + 1):
        parent = rng.integers(0, beam, size=(b, beam))
        anc = np.take_along_axis(anc, parent[:, :, None], axis=1)
        anc[:, :, t] = np.arange(beam)
    return anc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MASKED_SHAPES)
def test_beam_masked_attend_plain_matches_pallas_on_a_tree_ancestry(shape, dtype):
    """The ancestry that decoding produces (few distinct rows per position),
    which the CUDA kernel reads row by distinct row."""
    b, beam, heads, s, dh = shape
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b * heads, beam, dh))
    k = rng.normal(size=(b * heads, beam, s, dh))
    v = rng.normal(size=(b * heads, beam, s, dh))
    for idx in (0, s // 2, s - 1):
        anc = _tree_ancestry(rng, b, beam, s, idx)
        vb = _vbias(s, idx)
        got = tba.beam_masked_attend(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                     torch.tensor(anc), torch.tensor(vb), heads)
        want = jba.beam_masked_attend(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(anc),
                                      jnp.asarray(vb), heads, interpret=True)
        _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_diag_attend_plain_matches_pallas(dtype):
    b, beam, heads, s, dh = DIAG_SHAPE
    rng = np.random.default_rng(2)
    q = rng.normal(size=(b, beam, heads, dh))
    k = rng.normal(size=(b, heads, beam, s, dh))
    v = rng.normal(size=(b, heads, beam, s, dh))
    launches = tba.DIAG_LAUNCHES
    for idx in (0, 6, s - 1):
        vb = _vbias(s, idx)
        got = tba.beam_diag_attend(_t(q, dtype), _t(k, dtype), _t(v, dtype), torch.tensor(vb))
        want = jba.beam_diag_attend(_j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(vb),
                                    block_b=2, interpret=True)
        _check(got, want, dtype)
    assert tba.DIAG_LAUNCHES == launches


# (dtype, shape, sel): a random sel (the first two cases' ids as before),
# one row named by every beam of a sentence (late in a search, when the
# beams share one history) and the identity (no beam changes rows), at the
# JAX test's shape and at Dh 32.
REORDER_CASES = [
    pytest.param("float32", REORDER_SHAPE, "random", id="float32-shape0"),
    pytest.param("bfloat16", (2, 2, 2, 7, 64), "random", id="bfloat16-shape1"),
    pytest.param("bfloat16", REORDER_SHAPE, "random", id="bfloat16-random"),
    pytest.param("float32", REORDER_SHAPE, "one-row", id="float32-one-row"),
    pytest.param("bfloat16", REORDER_SHAPE, "one-row", id="bfloat16-one-row"),
    pytest.param("float32", REORDER_SHAPE, "identity", id="float32-identity"),
    pytest.param("bfloat16", REORDER_SHAPE, "identity", id="bfloat16-identity"),
    pytest.param("float32", (3, 5, 4, 11, 32), "random", id="float32-dh32"),
    pytest.param("bfloat16", (3, 5, 4, 11, 32), "one-row", id="bfloat16-dh32-one-row"),
]


@pytest.mark.parametrize("dtype,shape,sel_kind", REORDER_CASES)
def test_beam_reorder_attend_plain_matches_pallas(dtype, shape, sel_kind):
    b, beam, heads, s, dh = shape
    rng = np.random.default_rng(0)
    q, kn, vn = (rng.normal(size=(b, beam, heads, dh)) for _ in range(3))
    k, v = (rng.normal(size=(b, heads, beam, s, dh)) for _ in range(2))
    sel = rng.integers(0, beam, size=(b, beam)).astype(np.int32)
    if sel_kind == "one-row":
        sel = np.repeat(sel[:, :1], beam, axis=1)
    elif sel_kind == "identity":
        sel = np.tile(np.arange(beam, dtype=np.int32), (b, 1))
    launches = tba.REORDER_LAUNCHES
    for idx in (0, s // 2, s - 1):
        vb = _vbias(s, idx)
        woh = (np.arange(s) == idx).astype(np.float32)
        got = tba.beam_reorder_attend(*(_t(a, dtype) for a in (q, kn, vn, k, v)),
                                      torch.tensor(sel), torch.tensor(vb), torch.tensor(woh))
        want = jba.beam_reorder_attend(*(_j(a, dtype) for a in (q, kn, vn, k, v)),
                                       jnp.asarray(sel), jnp.asarray(vb), jnp.asarray(woh),
                                       interpret=True)
        _check(got[0], want[0], dtype)
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == DT[dtype][0]
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))
    assert tba.REORDER_LAUNCHES == launches


def _self_attn_params(rng, d):
    return {name: {"kernel": rng.normal(size=(d, d)).astype(np.float32) * d ** -0.5,
                   "bias": rng.normal(size=(d,)).astype(np.float32) * 0.1}
            for name in ("q_proj", "k_proj", "v_proj", "output_proj")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads,dh", [(4, 8), (2, 64)])
def test_beam_self_attend_matches_jax(dtype, heads, dh):
    """The port's ``_beam_self_attend`` (core: the kernel's plain version)
    against the JAX einsum. fp32: 1e-5. bf16: the JAX einsum rounds P to
    bf16 before P @ V and the port does not; a rounding moves P by at most
    2^-9 of itself, so the attended values move by at most 2^-9 of max|v|,
    and the bf16 output projection carries that into the output scale:
    bound 2^-6 of max|output| (P's share plus the two outputs' roundings)."""
    b, beam, s = 3, 4, 9
    d = heads * dh
    rng = np.random.default_rng(11)
    params = _self_attn_params(rng, d)
    x = rng.normal(size=(b * beam, 1, d))
    k = rng.normal(size=(b, heads, beam, s, dh))
    v = rng.normal(size=(b, heads, beam, s, dh))
    anc = rng.integers(0, beam, size=(b, beam, s)).astype(np.int32)
    for idx in (0, 5, s - 1):
        got = ttr._beam_self_attend(
            {n: {kk: _t(a, dtype) for kk, a in p.items()} for n, p in params.items()},
            _t(x, dtype), _t(k, dtype), _t(v, dtype), torch.tensor(anc),
            ttr.valid_bias(s, idx, "cpu"), heads, beam)
        want = jtr._beam_self_attend(
            {n: {kk: _j(a, dtype) for kk, a in p.items()} for n, p in params.items()},
            _j(x, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(anc),
            jnp.asarray(idx, jnp.int32), heads, beam)
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2.0 ** -6 * np.abs(want).max()
