"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (Hopper, the kernels are built for sm_90a)
and skip without one. The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/unit/test_torch_port_gpu.py

Tolerance: every row's cosine >= 0.9999 against the plain version (rows of
length >= 1 for the int8 attention block), and each call counted as a launch.
"""

import pytest

torch = pytest.importorskip("torch")

from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, short_attn  # noqa: E402
from sonar_tpu_torch.ops.quantization import quantize_kernel  # noqa: E402

F32_MIN = torch.finfo(torch.float32).min
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(dev, *shape, scale=1.0, dtype=torch.float32, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed + sum(shape))
    return (torch.randn(*shape, generator=gen) * scale).to(dtype).to(dev)


def _key_bias(dev, lens, s):
    pos = torch.arange(s, device=dev)[None, :]
    return torch.where(pos < torch.tensor(lens, device=dev)[:, None], 0.0, F32_MIN).float()


def _assert_close(got, want, rows=None):
    got, want = got.float(), want.float()
    if rows is not None:
        got, want = got[rows], want[rows]
    g, w = got.reshape(-1, got.shape[-1]).double(), want.reshape(-1, want.shape[-1]).double()
    assert torch.isfinite(g).all()
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1)
    assert cos.min().item() >= 0.9999


def _launched(mod, fn):
    before = mod.LAUNCHES
    out = fn()
    torch.cuda.synchronize()
    assert mod.LAUNCHES == before + 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_short_attn_kernel(dev, dtype):
    qkv = _rand(dev, 4, 40, 3 * 128, scale=0.5, dtype=dtype)
    bias = _key_bias(dev, [40, 17, 0, 9], 40)
    got = _launched(short_attn, lambda: short_attn.short_qkv_attention(qkv, bias, 2))
    _assert_close(got, short_attn.short_qkv_attention_plain(qkv, bias, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("full", [False, True])
def test_flash_kernel(dev, dtype, full):
    q, k, v = (_rand(dev, 2, 2, 300, 64, dtype=dtype, seed=i) for i in range(3))
    if full:
        seg = torch.arange(300, device=dev) // 100
        bias = torch.where(seg[:, None] == seg[None, :], 0.0, F32_MIN).expand(2, 1, 300, 300)
    else:
        bias = _key_bias(dev, [300, 120], 300)[:, None, None, :]
    got = _launched(flash, lambda: flash.flash_attention(q, k, v, bias))
    _assert_close(got, flash.flash_attention_plain(q, k, v, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ln", [False, True])
def test_ffn_kernel(dev, dtype, ln):
    x = _rand(dev, 160, 128, scale=0.5, dtype=dtype)
    w1, s1 = quantize_kernel(_rand(dev, 128, 256, scale=0.05))
    w2, s2 = quantize_kernel(_rand(dev, 256, 128, scale=0.05))
    b1, b2 = _rand(dev, 256, scale=0.1), _rand(dev, 128, scale=0.1)
    lnp = (_rand(dev, 128, scale=0.1) + 1, _rand(dev, 128, scale=0.1, seed=1)) if ln \
        else (None, None)
    got = _launched(ffn, lambda: ffn._fused_ffn_impl(x, w1, s1, b1, w2, s2, b2, *lnp, 2))
    _assert_close(got, ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2, *lnp))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_kernel_keeps_per_split_scales(dev, dtype):
    """Halves of h 8x apart, with W2 evening out their shares of the output:
    the kernel agrees with the per-(row, half) plain version, which a single
    per-row scale would not."""
    x = _rand(dev, 160, 128, scale=0.5, dtype=dtype)
    w1, w2 = _rand(dev, 128, 256, scale=0.05), _rand(dev, 256, 128, scale=0.05)
    w1[:, :128] *= 8.0
    w2[:128] /= 8.0
    (w1, s1), (w2, s2) = quantize_kernel(w1), quantize_kernel(w2)
    b1, b2 = _rand(dev, 256, scale=0.1), _rand(dev, 128, scale=0.1)
    got = _launched(ffn, lambda: ffn.fused_int8_ffn(x, w1, s1, b1, w2, s2, b2))
    want = ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2)
    _assert_close(got, want)
    one = ffn.fused_ffn_plain(x, w1, s1, b1, w2, s2, b2, n_splits=1)
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() < (one.float() - want.float()).abs().max()
    if dtype == torch.float32:
        assert (got - want).abs().max() <= 5e-3 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block_kernel(dev, dtype):
    x = _rand(dev, 4, 40, 128, dtype=dtype)
    bias = _key_bias(dev, [40, 17, 0, 9], 40)
    wq, sq = quantize_kernel(_rand(dev, 128, 384, scale=0.05))
    wo, so = quantize_kernel(_rand(dev, 128, 128, scale=0.05))
    args = (x, bias, torch.ones(128, device=dev), torch.zeros(128, device=dev), wq, sq,
            _rand(dev, 384, scale=0.05), wo, so, _rand(dev, 128, scale=0.05), 2)
    got = _launched(attn_block, lambda: attn_block.fused_attn_block(*args))
    _assert_close(got, attn_block.fused_attn_block_plain(*args), rows=[0, 1, 3])


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        flash.flash_attention(*(_rand(dev, 1, 1, 8, 32) for _ in range(3)))  # head dim 32
    with pytest.raises(ValueError):
        short_attn.short_qkv_attention(_rand(dev, 1, 8, 96, dtype=torch.float16), None, 1)
    x = _rand(dev, 16, 96)
    w1, s1 = quantize_kernel(_rand(dev, 96, 256))
    w2, s2 = quantize_kernel(_rand(dev, 256, 96))
    with pytest.raises(ValueError):  # D = 96 is not a multiple of 128
        ffn.fused_int8_ffn(x, w1, s1, _rand(dev, 256), w2, s2, _rand(dev, 96))
    x = _rand(dev, 16, 128)
    w1, s1 = quantize_kernel(_rand(dev, 128, 256))
    w2, s2 = quantize_kernel(_rand(dev, 256, 128))
    with pytest.raises(ValueError):  # a row-major int8 weight
        ffn.fused_int8_ffn(x, w1.contiguous(), s1, _rand(dev, 256), w2, s2, _rand(dev, 128))
