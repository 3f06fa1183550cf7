"""The port's four kernels (plain PyTorch versions on CPU) against the JAX
Pallas kernels run in interpret mode, plus the numerics traps they must
reproduce. The CUDA kernels themselves run only on a card
(``test_torch_port_gpu.py``).

Tolerances: fp32 atol 2e-5; bf16 cosine >= 0.9999 per row; int8 products
bit-exact int32; int8 blocks cosine >= 0.999 per row, on rows of length >= 1.
"""

from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.ops.pallas.attn_block import fused_attn_block as jax_attn_block  # noqa: E402
from sonar_tpu.ops.pallas.ffn import fused_int8_ffn as jax_ffn  # noqa: E402
from sonar_tpu.ops.pallas.ffn import fused_int8_ffn_ln as jax_ffn_ln  # noqa: E402
from sonar_tpu.ops.pallas.short_attn import short_qkv_attention as jax_short  # noqa: E402
from sonar_tpu.ops.quantization import int8_linear as jax_int8_linear  # noqa: E402
from sonar_tpu.ops.quantization import quantize_kernel as jax_quantize_kernel  # noqa: E402
from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, short_attn  # noqa: E402
from sonar_tpu_torch.ops.cuda.int8_blocks import quant_rows  # noqa: E402
from sonar_tpu_torch.ops.quantization import (  # noqa: E402
    column_major,
    int8_linear,
    int8_matmul,
    is_column_major,
    quantize_kernel,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_flash_attention import _pallas_interpret  # noqa: E402

F32_MIN = float(np.finfo(np.float32).min)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _row_cos(a, b):
    a, b = _np(a).reshape(-1, _np(a).shape[-1]), _np(b).reshape(-1, _np(b).shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30)


def _key_bias(lens, s):
    return np.where(np.arange(s)[None, :] < np.asarray(lens)[:, None], 0.0, F32_MIN).astype(np.float32)


# -- K1: short fused-QKV attention ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_attn_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    b, s, h, dh = 3, 24, 4, 64
    qkv = rng.normal(size=(b, s, 3 * h * dh)) * 0.3
    bias = _key_bias([24, 11, 0], s)  # a padding row of length 0
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = short_attn.short_qkv_attention(_t(qkv, tdt), _t(bias), h)
    want = jax_short(_j(qkv, jdt), _j(bias), h, interpret=True)
    assert got.dtype == tdt and got.shape == (b, s, h * dh)
    assert np.isfinite(_np(got)).all()
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    else:
        assert _row_cos(got, want).min() >= 0.9999


def test_short_attn_fp32_output_option():
    rng = np.random.default_rng(1)
    qkv = _t(rng.normal(size=(2, 16, 3 * 128)) * 0.3, torch.bfloat16)
    out = short_attn.short_qkv_attention(qkv, None, 2, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(
        _np(out.to(torch.bfloat16)), _np(short_attn.short_qkv_attention(qkv, None, 2)), atol=0
    )


# -- K2: flash attention ---------------------------------------------------------


@pytest.mark.parametrize("dtype,dh,full", [
    ("float32", 64, False), ("float32", 128, True),
    ("bfloat16", 64, True), ("bfloat16", 128, False),
])
def test_flash_plain_matches_jax_kernel(dtype, dh, full):
    rng = np.random.default_rng(2)
    b, h, s = 2, 2, 256
    q, k, v = (rng.normal(size=(b, h, s, dh)) for _ in range(3))
    if full:
        seg = np.repeat(np.arange(1, 5), s // 4)
        bias = np.where(seg[:, None] == seg[None, :], 0.0, F32_MIN)
        bias = np.broadcast_to(bias, (b, 1, s, s)).astype(np.float32)
    else:
        bias = _key_bias([s, 100], s)[:, None, None, :]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = flash.flash_attention(*(_t(a, tdt) for a in (q, k, v)), bias=_t(bias))
    want = _pallas_interpret(*(_j(a, jdt) for a in (q, k, v)), _j(bias))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    else:
        assert _row_cos(got, want).min() >= 0.9999


# -- K3: int8 FFN ----------------------------------------------------------------


def _ffn_weights(rng, d=128, f=512):
    w1, w2 = rng.normal(size=(d, f)) * 0.05, rng.normal(size=(f, d)) * 0.05
    b1, b2 = rng.normal(size=(f,)) * 0.1, rng.normal(size=(d,)) * 0.1
    ln_s, ln_b = 1 + rng.normal(size=(d,)) * 0.1, rng.normal(size=(d,)) * 0.1
    return w1, b1, w2, b2, ln_s, ln_b


@pytest.mark.parametrize("apply_ln", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_plain_matches_jax_kernel(apply_ln, dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 128)) * 0.5
    w1, b1, w2, b2, ln_s, ln_b = _ffn_weights(rng)
    jw1, js1 = jax_quantize_kernel(_j(w1))
    jw2, js2 = jax_quantize_kernel(_j(w2))
    tw1, ts1 = torch.tensor(np.asarray(jw1)), _t(js1)
    tw2, ts2 = torch.tensor(np.asarray(jw2)), _t(js2)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    if apply_ln:
        got = ffn.fused_int8_ffn_ln(_t(x, tdt), _t(ln_s), _t(ln_b), tw1, ts1, _t(b1),
                                    tw2, ts2, _t(b2))
        want = jax_ffn_ln(_j(x, jdt), _j(ln_s), _j(ln_b), jw1, js1, _j(b1), jw2, js2,
                          _j(b2), block_m=16, interpret=True)
    else:
        got = ffn.fused_int8_ffn(_t(x, tdt), tw1, ts1, _t(b1), tw2, ts2, _t(b2))
        want = jax_ffn(_j(x, jdt), jw1, js1, _j(b1), jw2, js2, _j(b2), block_m=16,
                       interpret=True)
    assert got.dtype == tdt and got.shape == (40, 128)
    assert _row_cos(got, want).min() >= 0.999
    if dtype == "float32":
        # Same quantised operands, same rounding points: only fp32 sums differ.
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-2 * np.abs(_np(want)).max())


def test_ffn_keeps_per_split_scales():
    """The second quantisation has one scale per (row, half): the port with
    two splits is closer to the TPU kernel than a single full-row scale."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(32, 128))
    w1, b1, w2, b2, _, _ = _ffn_weights(rng)
    w1[:, :256] *= 8.0  # halves of very different magnitude
    jw1, js1 = jax_quantize_kernel(_j(w1))
    jw2, js2 = jax_quantize_kernel(_j(w2))
    want = _np(jax_ffn(_j(x), jw1, js1, _j(b1), jw2, js2, _j(b2), block_m=16, interpret=True))
    args = (_t(x), torch.tensor(np.asarray(jw1)), _t(js1), _t(b1),
            torch.tensor(np.asarray(jw2)), _t(js2), _t(b2))
    two = _np(ffn.fused_int8_ffn(*args, n_splits=2))
    one = _np(ffn.fused_int8_ffn(*args, n_splits=1))
    assert np.abs(two - want).max() < np.abs(one - want).max()
    np.testing.assert_allclose(two, want, atol=2e-5 * np.abs(want).max() + 2e-5)


# -- K4: int8 attention block --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_block_plain_matches_jax_kernel(dtype):
    rng = np.random.default_rng(5)
    b, s, h, dh = 4, 16, 2, 64
    d = h * dh
    x = rng.normal(size=(b, s, d)) * 0.5
    lens = np.asarray([16, 9, 0, 3])  # a padding row of length 0
    bias = _key_bias(lens, s)
    ln_s, ln_b = 1 + rng.normal(size=(d,)) * 0.1, rng.normal(size=(d,)) * 0.1
    jwq, jsq = jax_quantize_kernel(_j(rng.normal(size=(d, 3 * d)) * 0.05))
    jwo, jso = jax_quantize_kernel(_j(rng.normal(size=(d, d)) * 0.05))
    bq, bo = rng.normal(size=(3 * d,)) * 0.05, rng.normal(size=(d,)) * 0.05
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = attn_block.fused_attn_block(
        _t(x, tdt), _t(bias), _t(ln_s), _t(ln_b), torch.tensor(np.asarray(jwq)), _t(jsq),
        _t(bq), torch.tensor(np.asarray(jwo)), _t(jso), _t(bo), h)
    want = jax_attn_block(_j(x, jdt), _j(bias), _j(ln_s), _j(ln_b), jwq, jsq, _j(bq), jwo,
                          jso, _j(bo), num_heads=h, block_b=2, interpret=True)
    assert got.dtype == tdt and got.shape == (b, s, d)
    assert np.isfinite(_np(got)).all()
    valid = lens > 0
    assert _row_cos(_np(got)[valid], _np(want)[valid]).min() >= 0.999


def test_attn_block_rounds_qkv_to_bf16_for_fp32_models():
    """The TPU kernel casts the dequantised QKV to bf16 even for an fp32 x:
    the port's fp32 block agrees with the bf16-cast composition, not with
    an fp32-QKV one."""
    rng = np.random.default_rng(6)
    b, s, h, dh = 2, 8, 2, 64
    d = h * dh
    x = _t(rng.normal(size=(b, s, d)))
    ln_s, ln_b = torch.ones(d), torch.zeros(d)
    wq, sq = quantize_kernel(_t(rng.normal(size=(d, 3 * d)) * 0.05))
    wo, so = quantize_kernel(_t(rng.normal(size=(d, d)) * 0.05))
    bq, bo = torch.zeros(3 * d), torch.zeros(d)
    got = attn_block.fused_attn_block(x, None, ln_s, ln_b, wq, sq, bq, wo, so, bo, h)
    want = jax_attn_block(_j(x), None, _j(ln_s), _j(ln_b), jnp.asarray(wq.numpy()),
                          _j(sq), _j(bq), jnp.asarray(wo.numpy()), _j(so), _j(bo),
                          num_heads=h, block_b=2, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


# -- shared int8 pieces and numerics traps --------------------------------------------


def test_int8_matmul_is_exact_int32():
    rng = np.random.default_rng(7)
    a = rng.integers(-127, 128, size=(33, 8192), dtype=np.int8)
    b = rng.integers(-127, 128, size=(8192, 24), dtype=np.int8)
    want = a.astype(np.int64) @ b.astype(np.int64)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    jax_acc = jax.lax.dot_general(jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_acc))


def test_quantize_kernel_stores_column_major():
    """The CUDA GEMMs and ``torch._int_mm`` read an [in, out] int8 kernel
    column-major: ``quantize_kernel`` stores it so once (every layer of a
    stack too), with the JAX values, and ``int8_matmul`` reads it uncopied."""
    w = np.random.default_rng(10).normal(size=(3, 96, 40))
    q, scale = quantize_kernel(_t(w))
    jq, js = jax_quantize_kernel(_j(w))
    assert q.shape == (3, 96, 40) and q.stride() == (96 * 40, 1, 96)
    assert is_column_major(q[1]) and is_column_major(q[1].to("meta"))
    assert column_major(q[1]).data_ptr() == q[1].data_ptr()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    a = torch.from_numpy(np.random.default_rng(11).integers(-127, 128, (24, 96), dtype=np.int8))
    np.testing.assert_array_equal(int8_matmul(a, q[2]).numpy(),
                                  a.numpy().astype(np.int64) @ q[2].numpy().astype(np.int64))


def test_quantisation_rounds_half_to_even():
    # absmax 127 -> scale 1: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2 (jnp.round semantics).
    x = torch.tensor([[127.0, 2.5, 3.5, -2.5, 0.5, 1.5]])
    q, scale = quant_rows(x)
    assert scale.item() == 1.0
    assert q.tolist() == [[127, 2, 4, -2, 0, 2]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(dtype):
    """int8_linear quantises with the reciprocal and takes the absmax in the
    input dtype; the port copies both."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(3, 5, 96))
    w, bias = rng.normal(size=(96, 40)) * 0.1, rng.normal(size=(40,))
    jq, js = jax_quantize_kernel(_j(w))
    tq, ts = quantize_kernel(_t(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = int8_linear({"kernel_q": tq, "scale": ts, "bias": _t(bias)}, _t(x, tdt))
    want = jax_int8_linear({"kernel_q": jq, "scale": js, "bias": _j(bias)}, _j(x, jdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    else:
        assert _row_cos(got, want).min() >= 0.9999


def test_wrappers_take_the_plain_path_on_cpu():
    rng = np.random.default_rng(9)
    before = (short_attn.LAUNCHES, flash.LAUNCHES, ffn.LAUNCHES, attn_block.LAUNCHES)
    short_attn.short_qkv_attention(_t(rng.normal(size=(1, 8, 192))), None, 1)
    q = _t(rng.normal(size=(1, 1, 8, 64)))
    flash.flash_attention(q, q, q)
    after = (short_attn.LAUNCHES, flash.LAUNCHES, ffn.LAUNCHES, attn_block.LAUNCHES)
    assert before == after
