"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (Hopper, the kernels are built for sm_90a)
and skip without one. The machine with the card has no JAX, and
``tests/conftest.py`` imports it, so run them there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/unit/test_torch_port_gpu.py

Tolerance: every row's cosine >= 0.9999 against the plain version (rows of
length >= 1 for the int8 attention block), and each call counted as a launch.
Training: one step on the card launches no kernel and gives the gradients
of the same step on the CPU. The kernel-selection scope: a decoder runtime
captures once per setting and replays the first capture when the setting
returns; inside ``no_cuda_kernels()`` a beam and a sampling decode launch
no kernel.
"""

import pytest

torch = pytest.importorskip("torch")

from sonar_tpu_torch.nn.conformer import _trig_tables  # noqa: E402
from sonar_tpu_torch.ops.cuda import (  # noqa: E402
    attn_block,
    beam_attend,
    ffn,
    flash,
    layer_norm,
    relpos_flash,
    short_attn,
)
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


def _launched(mod, fn, counter="LAUNCHES"):
    before = getattr(mod, counter)
    out = fn()
    torch.cuda.synchronize()
    assert getattr(mod, counter) == before + 1
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


# The bf16 tensor-core core (csrc/attention.cuh): the one-pass kernel at
# every length the short attention takes, the two-pass kernel past 128 keys.


@pytest.mark.gpu
@pytest.mark.parametrize("s", [8, 16, 40, 128])
def test_short_attn_kernel_bf16_lengths(dev, s):
    qkv = _rand(dev, 5, s, 3 * 1024, scale=0.5, dtype=torch.bfloat16)
    bias = _key_bias(dev, [s, s // 2, 1, s - 3, 0], s)  # with a row of length 0
    got = _launched(short_attn, lambda: short_attn.short_qkv_attention(qkv, bias, 16))
    _assert_close(got, short_attn.short_qkv_attention_plain(qkv, bias, 16))


@pytest.mark.gpu
@pytest.mark.parametrize("heads,dh", [(2, 40), (3, 5), (1, 128), (4, 24)])
def test_short_attn_kernel_bf16_head_dims(dev, heads, dh):
    """Head dims that are not a multiple of 16 (40, 5, 24: zero-padded in the
    kernel, odd ones without 16-byte copies), and the largest, 128."""
    qkv = _rand(dev, 3, 33, 3 * heads * dh, scale=0.5, dtype=torch.bfloat16)
    bias = _key_bias(dev, [33, 20, 0], 33)
    got = _launched(short_attn, lambda: short_attn.short_qkv_attention(qkv, bias, heads))
    assert got.shape == (3, 33, heads * dh)
    _assert_close(got, short_attn.short_qkv_attention_plain(qkv, bias, heads))


@pytest.mark.gpu
@pytest.mark.parametrize("bias_lens", [None, [64, 30, 0, 1]])
def test_short_attn_kernel_bf16_fp32_out(dev, bias_lens):
    qkv = _rand(dev, 4, 64, 3 * 256, scale=0.5, dtype=torch.bfloat16)
    bias = None if bias_lens is None else _key_bias(dev, bias_lens, 64)
    got = _launched(short_attn, lambda: short_attn.short_qkv_attention(
        qkv, bias, 4, out_dtype=torch.float32))
    assert got.dtype == torch.float32
    _assert_close(got, short_attn.short_qkv_attention_plain(qkv, bias, 4,
                                                            out_dtype=torch.float32))


@pytest.mark.gpu
def test_softmax_division_matches_fdiv_rn(dev):
    """The core's division (reciprocal hoisted, two residual corrections;
    __fdiv_rn below 2^-100) against __fdiv_rn, bit for bit, on 2^26 pairs."""
    from sonar_tpu_torch.ops import _build

    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    _build.check(_build.library().sonar_check_softmax_division(
        2 ** 24, 7, counts.data_ptr(), _build.stream_of(counts)), "softmax division check")
    assert counts.tolist() == [2 ** 26, 0, 0]


def _flash_bias(dev, kind, b, s):
    if kind == "key":
        return _key_bias(dev, [s, s // 3, 1][:b], s)[:, None, None, :]
    if kind == "full":
        seg = torch.arange(s, device=dev) // 100
        return torch.where(seg[:, None] == seg[None, :], 0.0, F32_MIN).expand(b, 1, s, s)
    return None


@pytest.mark.gpu
@pytest.mark.parametrize("s", [130, 300, 512, 514])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("kind", ["key", "full", "none"])
def test_flash_kernel_bf16(dev, s, dh, kind):
    q, k, v = (_rand(dev, 3, 2, s, dh, dtype=torch.bfloat16, seed=i) for i in range(3))
    bias = _flash_bias(dev, kind, 3, s)
    got = _launched(flash, lambda: flash.flash_attention(q, k, v, bias))
    _assert_close(got, flash.flash_attention_plain(q, k, v, bias))


@pytest.mark.gpu
@pytest.mark.parametrize("s,dh", [(300, 64), (514, 128), (128, 64)])
def test_flash_kernel_bf16_strided_views(dev, s, dh):
    """q, k, v as ``mha`` passes them: head views of one fused projection
    [B, S, 3 D] (row stride 3 D, k and v offset by D and 2 D)."""
    heads, b = 4, 2
    qkv = _rand(dev, b, s, 3 * heads * dh, dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, s, heads, dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    bias = _flash_bias(dev, "key" if s > 128 else "full", b, s)
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
@pytest.mark.parametrize("m,d,f,n_splits", [(300, 128, 512, 1), (300, 128, 512, 2),
                                            (300, 128, 512, 4), (3992, 1024, 4096, 2)])
def test_bf16_ffn_kernel(dev, dtype, m, d, f, n_splits):
    """The Conformer half-FFN at the JAX test's shape (a ragged M) and at
    the full-width ``english`` encoder's; fp32 also to max-abs 2e-4."""
    x = _rand(dev, m, d, dtype=dtype)
    args = (x, _rand(dev, d, scale=0.1) + 1, _rand(dev, d, scale=0.1, seed=1),
            _rand(dev, d, f, scale=d ** -0.5, seed=2), _rand(dev, f, scale=0.1, seed=3),
            _rand(dev, f, d, scale=f ** -0.5, seed=4), _rand(dev, d, scale=0.1, seed=5))
    got = _launched(ffn, lambda: ffn.fused_bf16_ffn_ln_residual(*args, n_splits=n_splits),
                    counter="BF16_LAUNCHES")
    want = ffn.fused_bf16_ffn_ln_residual_plain(*args, n_splits=n_splits)
    assert got.dtype == dtype and got.shape == (m, d)
    _assert_close(got, want)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-4


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
def test_attn_block_kernel_past_128_keys(dev):
    """The attention step in the two-pass kernel with its fp32 output."""
    x = _rand(dev, 2, 200, 256, dtype=torch.bfloat16)
    bias = _key_bias(dev, [200, 77], 200)
    wq, sq = quantize_kernel(_rand(dev, 256, 768, scale=0.05))
    wo, so = quantize_kernel(_rand(dev, 256, 256, scale=0.05))
    args = (x, bias, torch.ones(256, device=dev), torch.zeros(256, device=dev), wq, sq,
            _rand(dev, 768, scale=0.05), wo, so, _rand(dev, 256, scale=0.05), 4)
    got = _launched(attn_block, lambda: attn_block.fused_attn_block(*args))
    _assert_close(got, attn_block.fused_attn_block_plain(*args))


def _ffn_weights(dev, d, f, split_scales=False):
    w1, w2 = _rand(dev, d, f, scale=0.03, seed=1), _rand(dev, f, d, scale=0.01, seed=2)
    if split_scales:  # halves of h 8x apart, W2 evening out their shares
        w1[:, : f // 2] *= 8.0
        w2[: f // 2] /= 8.0
    (w1, s1), (w2, s2) = quantize_kernel(w1), quantize_kernel(w2)
    return w1, s1, _rand(dev, f, scale=0.05, seed=3), w2, s2, _rand(dev, d, scale=0.05, seed=4)


def _assert_int8_close(got, want, dtype):
    """The int8 tolerances of chip_smoke.py (c): 1e-2 of the output's scale
    in bf16, 5e-3 in fp32 (a value within rounding of a quantisation step
    may land one int8 level apart), row cosine >= 0.9999."""
    _assert_close(got, want)
    scale = want.float().abs().max().item()
    tol = 1e-2 if dtype == torch.bfloat16 else 5e-3
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,f,n_splits", [(1, 128, 256, 2), (127, 256, 512, 2),
                                            (300, 128, 512, 1), (300, 128, 512, 4),
                                            (8191, 1024, 8192, 2), (2048, 1024, 8192, 2),
                                            (2048, 1024, 8192, 4), (2048, 1024, 8192, 1),
                                            (300, 384, 640, 5)])
def test_ffn_kernel_edges(dev, dtype, m, d, f, n_splits):
    """The wgmma GEMMs' ragged last row tile (M 1, 127, 300, 8191), splits
    of F ending on the 128-byte k steps, the encoder's full width, and the
    quantisation's segments from 128 to 8192 values (D 384 and splits of
    128: a segment that leaves some of the register chunks empty)."""
    x = _rand(dev, m, d, dtype=dtype)
    lnp = (_rand(dev, d, scale=0.1) + 1, _rand(dev, d, scale=0.1, seed=1))
    w = _ffn_weights(dev, d, f)
    got = _launched(ffn, lambda: ffn._fused_ffn_impl(x, *w, *lnp, n_splits))
    assert got.dtype == dtype and got.shape == (m, d)
    _assert_int8_close(got, ffn.fused_ffn_plain(x, *w, *lnp, n_splits=n_splits), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_ffn_kernel_keeps_per_split_scales_full_width(dev, dtype):
    x = _rand(dev, 2048, 1024, dtype=dtype)
    w = _ffn_weights(dev, 1024, 8192, split_scales=True)
    got = _launched(ffn, lambda: ffn.fused_int8_ffn(x, *w))
    want = ffn.fused_ffn_plain(x, *w)
    _assert_int8_close(got, want, dtype)
    one = ffn.fused_ffn_plain(x, *w, n_splits=1)
    assert (got.float() - want.float()).abs().max() < (one.float() - want.float()).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_attn_block_kernel_full_width(dev, dtype):
    """The int8 block's two GEMMs on the wgmma core at [16, 128, 1024]."""
    x = _rand(dev, 16, 128, 1024, dtype=dtype)
    bias = _key_bias(dev, [128, 77, 1, 128] * 4, 128)
    wq, sq = quantize_kernel(_rand(dev, 1024, 3072, scale=0.03))
    wo, so = quantize_kernel(_rand(dev, 1024, 1024, scale=0.03))
    args = (x, bias, _rand(dev, 1024, scale=0.1) + 1, _rand(dev, 1024, scale=0.1, seed=1), wq, sq,
            _rand(dev, 3072, scale=0.05), wo, so, _rand(dev, 1024, scale=0.05), 16)
    flash_launches = flash.LAUNCHES
    got = _launched(attn_block, lambda: attn_block.fused_attn_block(*args))
    assert flash.LAUNCHES == flash_launches  # S 128: the one-pass attention step
    _assert_int8_close(got, attn_block.fused_attn_block_plain(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s", [(8, 192), (12, 200), (8, 300), (16, 384), (16, 512)])
def test_attn_block_kernel_full_width_long(dev, b, s):
    """The int8 block past S 128 at full width: its attention step is #5's
    two-pass core on the fused QKV rows, fp32 into merged heads, so each
    call counts one launch of #2 and one of #5. Ragged lengths and one row
    wholly padding (the static batcher's remainder rows), all of them
    within the int8 tolerances of the plain version; S 200 and 300 (dynamic
    batching's lengths) end in a partial 64-key tile."""
    x = _rand(dev, b, s, 1024, dtype=torch.bfloat16)
    lens = [s, 0] + [s // 2 + 37 * i % (s // 2) for i in range(b - 2)]
    bias = _key_bias(dev, lens, s)
    wq, sq = quantize_kernel(_rand(dev, 1024, 3072, scale=0.03))
    wo, so = quantize_kernel(_rand(dev, 1024, 1024, scale=0.03))
    args = (x, bias, _rand(dev, 1024, scale=0.1) + 1, _rand(dev, 1024, scale=0.1, seed=1), wq, sq,
            _rand(dev, 3072, scale=0.05), wo, so, _rand(dev, 1024, scale=0.05), 16)
    flash_launches = flash.LAUNCHES
    got = _launched(attn_block, lambda: attn_block.fused_attn_block(*args))
    assert flash.LAUNCHES == flash_launches + 1
    _assert_int8_close(got, attn_block.fused_attn_block_plain(*args), torch.bfloat16)


@pytest.mark.gpu
def test_attn_block_one_pass_max_is_the_librarys(dev):
    """The block gate's ``ONE_PASS_MAX`` (read without the library) is the
    built library's ``TC_ONE_PASS_MAX``, by which a call counts #5."""
    assert attn_block.one_pass_max() == attn_block.ONE_PASS_MAX


@pytest.mark.gpu
def test_int8_encoder_long_batch_on_the_card(dev):
    """A [16, 512] batch (ragged, one row wholly padding) through the 24
    full-width layers of the ``basic`` encoder in int8 (a vocabulary of
    3,000): on the card every layer launches #2 (its attention step #5's
    core) and #3 with LN, and each sentence's embedding is within cosine
    0.999 of the CPU's, which runs the kernels' plain versions."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    basic = sonar_text_encoder_archs.get("basic")
    cfg = dataclasses.replace(basic, vocab_info=dataclasses.replace(basic.vocab_info, size=3000))
    params = init_text_encoder_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    seqs = rng.integers(4, 3000, (16, 512)).astype(np.int32)
    lens = rng.integers(257, 511, 16).astype(np.int32)
    lens[0], lens[-1] = 512, 0
    for i, n in enumerate(lens):
        seqs[i, n:] = 1
    counters = (attn_block, "LAUNCHES"), (flash, "LAUNCHES"), (ffn, "LAUNCHES")
    outs = {}
    for device in (dev, "cpu"):
        enc = TorchTextEncoder(text_encoder_from_numpy(params, cfg, torch.bfloat16, device),
                               quantize=True, device=device)
        before = [getattr(m, c) for m, c in counters]
        outs[str(device)] = enc._encode(seqs, lens).float().cpu()
        if device == dev:
            torch.cuda.synchronize()
            assert [getattr(m, c) - n for (m, c), n in zip(counters, before)] == [24, 24, 24]
        del enc
    real = torch.from_numpy(lens > 0)
    got, want = outs[str(dev)][real], outs["cpu"][real]
    assert torch.isfinite(got).all()
    cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1)
    assert cos.min().item() >= 0.999


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


def _relpos_inputs(dev, dtype, s, dh, h=2, b=3):
    d = 2 * h * dh
    q, k, v = (_rand(dev, b, h, s, dh, dtype=dtype, seed=i) for i in range(3))
    wr = _rand(dev, h, d, dh, scale=d ** -0.5, dtype=dtype, seed=3)
    u, vb = (_rand(dev, h, dh, scale=0.1, dtype=dtype, seed=4 + i) for i in range(2))
    si, ci, basis = _trig_tables(s, d, dtype, dev)
    bias = _key_bias(dev, ([s, s // 3, 0] * b)[:b], s)  # with a row of length 0 (B >= 3)
    return q, k, v, wr, si, ci, basis, u, vb, bias


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,dh", [(130, 64), (257, 128)])
def test_relpos_v2_kernel(dev, dtype, s, dh):
    args = _relpos_inputs(dev, dtype, s, dh)
    got = _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args))
    _assert_close(got, relpos_flash.relpos_flash_attention_v2_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s,dh", [(3, 2, 128, 64), (3, 2, 129, 64), (1, 2, 1999, 64),
                                      (1, 2, 2048, 64), (1, 1, 2048, 128), (2, 3, 130, 64),
                                      (3, 5, 700, 128)])
def test_relpos_v2_kernel_edges(dev, dtype, b, h, s, dh):
    """The gate's ends (S 128, 2048), a key tile of one key (S 129), the
    speech batches' S 1999, row-block counts that are not a multiple of the
    cluster (S 130: 3 blocks of 64 rows; S 700: 11), head dim 128, and a
    batch row whose every key is masked (its output averages V)."""
    d = 1024
    q, k, v = (_rand(dev, b, h, s, dh, dtype=dtype, seed=i) for i in range(3))
    wr = _rand(dev, h, d, dh, scale=d ** -0.5, dtype=dtype, seed=3)
    u, vb = (_rand(dev, h, dh, scale=0.1, dtype=dtype, seed=4 + i) for i in range(2))
    si, ci, basis = _trig_tables(s, d, dtype, dev)
    bias = _key_bias(dev, [s, 0, s // 3][:b], s)
    args = (q, k, v, wr, si, ci, basis, u, vb, bias)
    got = _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args))
    want = relpos_flash.relpos_flash_attention_v2_plain(*args)
    _assert_close(got, want)
    scale = want.float().abs().max().item()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    if b > 1:  # the fully masked row: the mean of V, as the plain version gives it
        mean = v[1].float().mean(dim=-2, keepdim=True).expand(h, s, dh)
        assert (got[1].float() - mean).abs().max().item() <= 2e-2 * mean.abs().max().item()


# The bf16 kernel (the rel-shift form on the projected distance table, in
# two launches): the gate's ends, a key tile of one key, the speech cell's
# batch shapes (S 199, 999, 1999 at [16, 16, S, 64], D 1024) and Dh 128; a
# row of length 0 and one of length S // 3.
RT_SHAPES = [pytest.param(3, 2, 128, 64, 256, id="128-64"),
             pytest.param(3, 2, 129, 64, 256, id="129-64"),
             pytest.param(3, 4, 199, 64, 512, id="199-64"),
             pytest.param(16, 16, 999, 64, 1024, id="999-64-full"),
             pytest.param(16, 16, 1999, 64, 1024, id="1999-64-full"),
             pytest.param(3, 2, 2048, 64, 256, id="2048-64"),
             pytest.param(3, 2, 257, 128, 512, id="257-128")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,dh,d", RT_SHAPES)
def test_relpos_v2_bf16_kernel_rel_shift(dev, b, h, s, dh, d):
    """Against the plain version (the trig form) at the file's tolerance,
    the output's max-abs within 2e-2 of its scale, and the fully masked
    row the mean of V."""
    bf16 = torch.bfloat16
    q, k, v = (_rand(dev, b, h, s, dh, dtype=bf16, seed=i) for i in range(3))
    wr = _rand(dev, h, d, dh, scale=d ** -0.5, dtype=bf16, seed=3)
    u, vb = (_rand(dev, h, dh, scale=0.1, dtype=bf16, seed=4 + i) for i in range(2))
    si, ci, basis = _trig_tables(s, d, bf16, dev)
    bias = _key_bias(dev, ([s, s // 3, 0] * b)[:b], s)
    args = (q, k, v, wr, si, ci, basis, u, vb, bias)
    got = _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args))
    want = relpos_flash.relpos_flash_attention_v2_plain(*args)
    _assert_close(got, want)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * scale
    mean = v[2].float().mean(dim=-2, keepdim=True).expand(h, s, dh)
    assert (got[2].float() - mean).abs().max().item() <= 2e-2 * mean.abs().max().item()


def _relpos_kernels(fn):
    """fn() under torch.profiler on the card -> the names of the device
    kernels it ran whose names hold ``relpos_v2_rt_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if not str(e.device_type()).endswith("CPU") and "relpos_v2_rt_kernel" in e.name()]


@pytest.mark.gpu
def test_relpos_v2_bf16_launches_table_and_attention(dev):
    """One bf16 call adds 1 to LAUNCHES and runs the two kernels of the
    ``relpos_v2_rt_kernel`` prefix (the benchmark's reader sums them): the
    table, then the attention."""
    args = _relpos_inputs(dev, torch.bfloat16, 499, 64, h=16, b=8)
    relpos_flash.relpos_flash_attention_v2(*args)  # built and warm
    torch.cuda.synchronize()
    names = _relpos_kernels(
        lambda: _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args)))
    assert len(names) == 2
    assert sum("relpos_v2_rt_kernel_table" in n for n in names) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,dh", [(1, 16, 2048, 64), (2, 16, 1999, 64)])
def test_relpos_v2_kernel_repeats_bit_for_bit(dev, b, h, s, dh):
    """The bf16 kernel builds its distance table in a launch of its own
    and shares tiles across a cluster: twelve calls on the same inputs give
    the same bits, whatever the memory the table gets held before (NaN
    here: the zero rows before the first distance are written too)."""
    d = 1024
    q, k, v = (_rand(dev, b, h, s, dh, dtype=torch.bfloat16, seed=i) for i in range(3))
    wr = _rand(dev, h, d, dh, scale=d ** -0.5, dtype=torch.bfloat16, seed=3)
    u, vb = (_rand(dev, h, dh, scale=0.1, dtype=torch.bfloat16, seed=4 + i) for i in range(2))
    si, ci, basis = _trig_tables(s, d, torch.bfloat16, dev)
    args = (q, k, v, wr, si, ci, basis, u, vb, _key_bias(dev, [s, s - 37][:b], s))
    outs = []
    for _ in range(12):
        # The freed NaN block is what the wrapper's table gets next.
        torch.full((h, 2 * s - 1 + relpos_flash.TABLE_PAD, dh), float("nan"),
                   dtype=torch.bfloat16, device=dev)
        outs.append(relpos_flash.relpos_flash_attention_v2(*args))
    assert torch.isfinite(outs[0]).all()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    _assert_close(outs[0], relpos_flash.relpos_flash_attention_v2_plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_relpos_v2_kernel_in_batch_chunks(dev, dtype, monkeypatch):
    """fp32: a workspace of one batch row, the batch goes through in three
    launches. bf16 takes no workspace: a batch of 32 goes through in one
    launch of each kernel, whatever WORKSPACE_BYTES says."""
    monkeypatch.setattr(relpos_flash, "WORKSPACE_BYTES", 1)
    if dtype == torch.bfloat16:
        def no_workspace(*a, **k):
            raise AssertionError("bf16 v2 asked for a workspace")

        monkeypatch.setattr(relpos_flash, "_workspace", no_workspace)
        args = _relpos_inputs(dev, dtype, 257, 64, b=32)
        out = []
        names = _relpos_kernels(lambda: out.append(
            _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args))))
        assert len(names) == 2
        got = out[0]
    else:
        args = _relpos_inputs(dev, dtype, 257, 64)
        got = _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention_v2(*args))
    _assert_close(got, relpos_flash.relpos_flash_attention_v2_plain(*args))


# (B, H, S, Dh): v1's bf16 kernel takes 32 query rows a block up to S ~1400
# and 16 past that (S 1999, 2048), beside a ring of one slot at S 3328 (the
# longest S the kernel before it took).
V1_SHAPES = [pytest.param(3, 2, 130, 64, id="130-64"), pytest.param(3, 2, 257, 128, id="257-128"),
             pytest.param(8, 4, 499, 64, id="499-64"), pytest.param(2, 4, 1000, 64, id="1000-64"),
             pytest.param(2, 16, 1999, 64, id="1999-64"),
             pytest.param(1, 8, 2048, 128, id="2048-128"),
             pytest.param(1, 2, 3328, 64, id="3328-64"), pytest.param(1, 2, 3328, 128, id="3328-128")]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,s,dh", V1_SHAPES)
def test_relpos_v1_kernel(dev, dtype, b, h, s, dh):
    """Against the plain version; a second call on the same inputs gives the
    same bits."""
    q, k, v, _, _, _, _, u, _, bias = _relpos_inputs(dev, dtype, s, dh, h=h, b=b)
    bd = _rand(dev, b, h, s, s, dtype=dtype, seed=9)
    got = _launched(relpos_flash, lambda: relpos_flash.relpos_flash_attention(q, k, v, bd, u, bias),
                    counter="V1_LAUNCHES")
    _assert_close(got, relpos_flash.relpos_flash_attention_plain(q, k, v, bd, u, bias))
    assert torch.equal(relpos_flash.relpos_flash_attention(q, k, v, bd, u, bias), got)


@pytest.mark.gpu
def test_relpos_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, k, v, wr, si, ci, basis, u, vb, bias = _relpos_inputs(dev, torch.float32, 130, 64)
    with pytest.raises(ValueError):  # tables in another dtype than q
        relpos_flash.relpos_flash_attention_v2(q, k, v, wr, si.bfloat16(), ci, basis, u, vb, bias)
    with pytest.raises(ValueError):  # head dim 32
        q32 = _rand(dev, 3, 2, 130, 32)
        relpos_flash.relpos_flash_attention(q32, q32, q32, _rand(dev, 3, 2, 130, 130),
                                            _rand(dev, 2, 32), bias)
    with pytest.raises(ValueError):  # a key bias of the wrong shape
        relpos_flash.relpos_flash_attention(q, k, v, _rand(dev, 3, 2, 130, 130), u, bias[:, :64])


def _beam_inputs(dev, dtype, b, beam, h, s, dh, idx):
    q = _rand(dev, b, beam, h, dh, dtype=dtype, seed=1)
    k, v = (_rand(dev, b, h, beam, s, dh, dtype=dtype, seed=2 + i) for i in range(2))
    gen = torch.Generator().manual_seed(s + idx)
    anc = torch.randint(0, beam, (b, beam, s), generator=gen, dtype=torch.int32).to(dev)
    sel = torch.randint(0, beam, (b, beam), generator=gen, dtype=torch.int32).to(dev)
    pos = torch.arange(s, device=dev)
    vbias = torch.where(pos <= idx, 0.0, -1e30).float()
    return q, k, v, anc, sel, vbias, (pos == idx).float()


# The beam kernels' shapes: those of the JAX kernel tests and the beam-decode
# path of the full-width decoder (B 32, K 5, H 16, S 51, Dh 64).
BEAM_SHAPES = [(2, 5, 16, 11, 64, 5), (3, 2, 4, 7, 32, 6), (32, 5, 16, 51, 64, 20)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", BEAM_SHAPES)
def test_beam_masked_attend_kernel(dev, dtype, shape):
    b, beam, h, s, dh, idx = shape
    q, k, v, anc, _, vbias, _ = _beam_inputs(dev, dtype, b, beam, h, s, dh, idx)
    qbh = q.permute(0, 2, 1, 3).reshape(b * h, beam, dh).contiguous()
    kc, vc = k.reshape(b * h, beam, s, dh), v.reshape(b * h, beam, s, dh)
    got = _launched(beam_attend, lambda: beam_attend.beam_masked_attend(qbh, kc, vc, anc, vbias, h),
                    counter="MASKED_LAUNCHES")
    _assert_close(got, beam_attend.beam_masked_attend_plain(qbh, kc, vc, anc, vbias, h))


# BEAM_SHAPES (ids as before), then a cache of 259 positions (a span of 201
# streamed in chunks), idx 0 (one valid position), K 1 and 16, Dh 32 and 128,
# idx S - 1 (the whole cache), and no valid position at all (every position
# counts, as in the reference).
DIAG_CASES = [pytest.param(shape, id=f"shape{i}") for i, shape in enumerate(BEAM_SHAPES)]
DIAG_CASES += [pytest.param(shape, id="-".join(map(str, shape))) for shape in [
    (32, 5, 16, 259, 64, 200), (32, 5, 16, 51, 64, 0), (4, 1, 2, 51, 64, 25),
    (2, 16, 2, 51, 128, 25), (3, 5, 4, 51, 32, 50), (2, 5, 4, 259, 128, 200),
    (2, 3, 2, 259, 32, 0), (2, 5, 2, 40, 64, -1)]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", DIAG_CASES)
def test_beam_diag_attend_kernel(dev, dtype, shape):
    """Against the plain version; on caches holding NaN at every position
    past idx, the same bits (those positions are never read); a second call
    gives the same bits."""
    b, beam, h, s, dh, idx = shape
    q, k, v, _, _, vbias, _ = _beam_inputs(dev, dtype, b, beam, h, s, dh, idx)
    got = _launched(beam_attend, lambda: beam_attend.beam_diag_attend(q, k, v, vbias),
                    counter="DIAG_LAUNCHES")
    _assert_close(got, beam_attend.beam_diag_attend_plain(q, k, v, vbias))
    assert torch.equal(beam_attend.beam_diag_attend(q, k, v, vbias), got)
    if idx >= 0:
        past = (torch.arange(s, device=dev) > idx)[None, None, None, :, None]
        kp, vp = k.masked_fill(past, float("nan")), v.masked_fill(past, float("nan"))
        assert torch.equal(beam_attend.beam_diag_attend(q, kp, vp, vbias), got)


# (B, K, H, S, Dh, idx, sel): BEAM_SHAPES with a random sel (ids as before),
# then sel naming one row for every beam of a sentence and the identity,
# K 1 and 16, Dh 32 and 128, idx 0 and S - 1, and caches of 259 positions
# (staged in several chunks; so are K 16, Dh 128 at S 51).
REORDER_CASES = [pytest.param(shape, "random", id=f"shape{i}") for i, shape in enumerate(BEAM_SHAPES)]
REORDER_CASES += [pytest.param(shape, sel, id=f"{'-'.join(map(str, shape))}-{sel}") for shape, sel in [
    ((32, 5, 16, 51, 64, 25), "one-row"), ((32, 5, 16, 51, 64, 25), "identity"),
    ((4, 1, 2, 51, 64, 25), "random"), ((3, 5, 4, 51, 32, 0), "random"),
    ((3, 5, 4, 51, 128, 50), "one-row"), ((2, 16, 2, 51, 128, 25), "random"),
    ((4, 5, 4, 259, 64, 200), "random"), ((2, 5, 4, 259, 64, 258), "identity"),
    ((2, 3, 2, 259, 32, 0), "one-row")]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,sel_kind", REORDER_CASES)
def test_beam_reorder_attend_kernel(dev, dtype, shape, sel_kind):
    """Against the plain version, the new caches equal bit for bit; a second
    call on the same inputs gives the same bits."""
    b, beam, h, s, dh, idx = shape
    q, k, v, _, sel, vbias, woh = _beam_inputs(dev, dtype, b, beam, h, s, dh, idx)
    if sel_kind == "one-row":
        sel = sel[:, :1].expand(b, beam).contiguous()
    elif sel_kind == "identity":
        sel = torch.arange(beam, dtype=torch.int32, device=dev).expand(b, beam).contiguous()
    kn, vn = (_rand(dev, b, beam, h, dh, dtype=dtype, seed=7 + i) for i in range(2))
    args = (q, kn, vn, k, v, sel, vbias, woh)
    got = _launched(beam_attend, lambda: beam_attend.beam_reorder_attend(*args),
                    counter="REORDER_LAUNCHES")
    want = beam_attend.beam_reorder_attend_plain(*args)
    _assert_close(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    again = beam_attend.beam_reorder_attend(*args)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.gpu
def test_beam_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q, k, v, anc, _, vbias, _ = _beam_inputs(dev, torch.float32, 2, 3, 2, 9, 64, 4)
    qbh = q.permute(0, 2, 1, 3).reshape(4, 3, 64).contiguous()
    kc, vc = k.reshape(4, 3, 9, 64), v.reshape(4, 3, 9, 64)
    with pytest.raises(ValueError):  # caches in another dtype than q
        beam_attend.beam_masked_attend(qbh, kc.bfloat16(), vc.bfloat16(), anc, vbias, 2)
    with pytest.raises(ValueError):  # int64 ancestry
        beam_attend.beam_masked_attend(qbh, kc, vc, anc.long(), vbias, 2)
    with pytest.raises(ValueError):  # head dim 48
        beam_attend.beam_diag_attend(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                     v[..., :48].contiguous(), vbias)
    with pytest.raises(ValueError):  # a cache view 2 bytes off 16-byte alignment
        flat = torch.empty(k.numel() + 1, dtype=k.dtype, device=dev)
        beam_attend.beam_diag_attend(q, flat[1:].view(k.shape), v, vbias)


def _tree_ancestry(gen, b, beam, s, idx):
    """[B, K, S] int32 ancestry as beam search builds it: the identity, then
    at each step 0..idx every beam takes a random parent's table and names
    its own row at the step's position."""
    rows = torch.arange(beam, dtype=torch.int32)
    anc = rows[None, :, None].expand(b, beam, s).contiguous()
    for t in range(idx + 1):
        parent = torch.randint(0, beam, (b, beam), generator=gen)
        anc = torch.gather(anc, 1, parent[:, :, None].expand(b, beam, s))
        anc[:, :, t] = rows
    return anc.contiguous()


def _masked_inputs(dev, dtype, b, beam, h, s, dh, idx, kind):
    q = _rand(dev, b * h, beam, dh, dtype=dtype, seed=1)
    k, v = (_rand(dev, b * h, beam, s, dh, dtype=dtype, seed=2 + i) for i in range(2))
    gen = torch.Generator().manual_seed(s + idx + beam)
    anc = (_tree_ancestry(gen, b, beam, s, idx) if kind == "tree"
           else torch.randint(0, beam, (b, beam, s), generator=gen, dtype=torch.int32))
    vbias = torch.where(torch.arange(s, device=dev) <= idx, 0.0, -1e30).float()
    return q, k, v, anc.to(dev), vbias


# (B, K, H, S, Dh, idx, ancestry): every K of 1, 2, 5, 16, every Dh of 32, 64,
# 128, idx 0 and S - 1, caches of 51 (one block a head) and 259 positions
# (split over blocks, partials combined), tree and random ancestries.
MASKED_CASES = [
    (4, 1, 2, 51, 64, 25, "random"), (4, 2, 2, 51, 32, 0, "tree"),
    (4, 5, 4, 51, 64, 50, "tree"), (2, 16, 2, 51, 128, 25, "random"),
    (2, 16, 2, 259, 64, 258, "random"), (3, 5, 4, 259, 128, 0, "random"),
    (3, 2, 2, 259, 32, 130, "random"), (8, 5, 4, 259, 64, 200, "tree"),
    (32, 5, 16, 259, 64, 200, "tree"), (32, 5, 16, 259, 64, 200, "random"),
    (2, 1, 2, 259, 128, 258, "tree"), (2, 16, 2, 51, 32, 50, "tree"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", MASKED_CASES)
def test_beam_masked_attend_kernel_cases(dev, dtype, case):
    b, beam, h, s, dh, idx, kind = case
    q, k, v, anc, vbias = _masked_inputs(dev, dtype, b, beam, h, s, dh, idx, kind)
    got = _launched(beam_attend, lambda: beam_attend.beam_masked_attend(q, k, v, anc, vbias, h),
                    counter="MASKED_LAUNCHES")
    want = beam_attend.beam_masked_attend_plain(q, k, v, anc, vbias, h)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want)
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["tree", "random"])
@pytest.mark.parametrize("s,idx", [(51, 25), (259, 200)])
def test_beam_masked_attend_reads_only_named_rows(dev, dtype, kind, s, idx):
    """NaN at every position past idx and in every (row, position) pair no
    beam names: the kernel on the poisoned cache equals the plain version on
    the clean one."""
    b, beam, h, dh = 8, 5, 4, 64
    q, k, v, anc, vbias = _masked_inputs(dev, dtype, b, beam, h, s, dh, idx, kind)
    named = torch.zeros(b, beam, s, dtype=torch.bool, device=dev)
    named.scatter_(1, anc.long(), True)
    named &= torch.arange(s, device=dev) <= idx
    poison = (~named)[:, None, :, :, None].expand(b, h, beam, s, dh).reshape(k.shape)
    kp, vp = k.masked_fill(poison, float("nan")), v.masked_fill(poison, float("nan"))
    got = beam_attend.beam_masked_attend(q, kp, vp, anc, vbias, h)
    _assert_close(got, beam_attend.beam_masked_attend_plain(q, k, v, anc, vbias, h))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["tree", "random"])
def test_beam_masked_attend_repeats_bit_for_bit(dev, kind):
    """The long cache goes through partials and a combining launch: calls on
    the same inputs give the same bits."""
    b, beam, h, s, dh, idx = 32, 5, 16, 259, 64, 200
    q, k, v, anc, vbias = _masked_inputs(dev, torch.bfloat16, b, beam, h, s, dh, idx, kind)
    outs = [beam_attend.beam_masked_attend(q, k, v, anc, vbias, h) for _ in range(8)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.isfinite(outs[0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("bh", [16, 128, 512])
def test_beam_masked_attend_keeps_a_short_cache_in_one_block(dev, bh):
    """A cache of at most 64 positions (the decode paths' 51) is one tile at
    any batch: one launch and no workspace; a longer one is split."""
    for s in (1, 51, 64):
        assert beam_attend.masked_tiles(bh, s) == (s, 1)
    tile, nsplit = beam_attend.masked_tiles(bh, 259)
    assert 32 <= tile <= 64 and nsplit == -(-259 // tile) > 1


@pytest.mark.gpu
def test_beam_masked_attend_raises_on_what_the_kernel_does_not_take(dev):
    q, k, v, anc, vbias = _masked_inputs(dev, torch.float32, 2, 3, 2, 9, 64, 4, "random")
    with pytest.raises(ValueError):  # 17 beams
        beam_attend.beam_masked_attend(q.repeat(1, 6, 1)[:, :17].contiguous(),
                                       k, v, anc.repeat(1, 6, 1)[:, :17].contiguous(), vbias, 2)
    with pytest.raises(ValueError):  # 33 cache rows a sentence
        kk = k.repeat(1, 11, 1, 1)
        beam_attend.beam_masked_attend(q, kk, kk, anc, vbias, 2)
    with pytest.raises(ValueError):  # head dim 48
        beam_attend.beam_masked_attend(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                       v[..., :48].contiguous(), anc, vbias, 2)
    with pytest.raises(ValueError):  # a bias of another length than the cache
        beam_attend.beam_masked_attend(q, k, v, anc, vbias[:8].contiguous(), 2)
    with pytest.raises(ValueError):  # B*H not a multiple of the heads
        beam_attend.beam_masked_attend(q, k, v, anc, vbias, 3)
    with pytest.raises(ValueError):  # a non-contiguous cache
        beam_attend.beam_masked_attend(q, k.transpose(1, 2), v, anc, vbias, 2)


def _ffn_args(dev, dtype, m, d, f):
    return (_rand(dev, m, d, dtype=dtype), _rand(dev, d, scale=0.1) + 1,
            _rand(dev, d, scale=0.1, seed=1), _rand(dev, d, f, scale=d ** -0.5, seed=2).to(dtype),
            _rand(dev, f, scale=0.1, seed=3), _rand(dev, f, d, scale=f ** -0.5, seed=4).to(dtype),
            _rand(dev, d, scale=0.1, seed=5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,d,f,n_splits", [(1, 128, 512, 1), (127, 1024, 4096, 2),
                                            (300, 1024, 512, 4), (127, 128, 4096, 1),
                                            (8192, 1024, 4096, 4), (3992, 1024, 4096, 1),
                                            (1, 1024, 4096, 2)])
def test_bf16_ffn_kernel_edges(dev, dtype, m, d, f, n_splits):
    """Ragged M from 1 row to 8192, D 128 and 1024, F 512 and 4096 in 1, 2
    and 4 splits, the weights in the model dtype: bf16 to one bf16 ulp of the
    output scale, fp32 to max-abs 2e-4."""
    args = _ffn_args(dev, dtype, m, d, f)
    got = _launched(ffn, lambda: ffn.fused_bf16_ffn_ln_residual(*args, n_splits=n_splits),
                    counter="BF16_LAUNCHES")
    want = ffn.fused_bf16_ffn_ln_residual_plain(*args, n_splits=n_splits)
    assert got.dtype == dtype and got.shape == (m, d)
    _assert_close(got, want)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2e-4 if dtype == torch.float32 else 2.0 ** -7 * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_bf16_ffn_kernel_reads_weights_in_place(dev, dtype):
    """The weights of the model dtype are neither copied nor changed: the
    call allocates far less than one weight (ln, h and the output of one
    row), and the weights keep their storage and their bits."""
    args = _ffn_args(dev, dtype, 1, 1024, 4096)
    w1, w2 = args[3], args[5]
    before = (w1.data_ptr(), w2.data_ptr(), w1.clone(), w2.clone())
    ffn.fused_bf16_ffn_ln_residual(*args)  # build and warm up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ffn.fused_bf16_ffn_ln_residual(*args)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < w1.numel() * w1.element_size() // 8
    assert (w1.data_ptr(), w2.data_ptr()) == before[:2]
    assert torch.equal(w1, before[2]) and torch.equal(w2, before[3])


@pytest.mark.gpu
def test_bf16_ffn_kernel_raises_on_what_it_does_not_take(dev):
    args = _ffn_args(dev, torch.bfloat16, 16, 128, 384)
    with pytest.raises(ValueError):  # bf16 splits of 96: not a multiple of 64
        ffn.fused_bf16_ffn_ln_residual(*args, n_splits=4)
    args = _ffn_args(dev, torch.bfloat16, 16, 128, 512)
    with pytest.raises(ValueError):  # a transposed (non-contiguous) weight
        ffn.fused_bf16_ffn_ln_residual(*args[:3], args[3].t().contiguous().t(), *args[4:])
    with pytest.raises(ValueError):  # D = 96
        ffn.fused_bf16_ffn_ln_residual(*_ffn_args(dev, torch.bfloat16, 16, 96, 512))


@pytest.mark.gpu
def test_no_path_launches_the_half_ffn(dev):
    """Neither beam decoding nor the speech encoder calls the half-FFN
    kernel (the Conformer keeps its plain branch, as the JAX one does);
    decoding goes through the masked attend."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import (
        init_speech_encoder_params,
        init_text_decoder_params,
        speech_encoder_from_numpy,
        text_decoder_from_numpy,
    )
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.nn.conformer import ConformerConfig

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    dec = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg,
                                                   torch.bfloat16, device=dev), device=dev)
    base = sonar_speech_encoder_archs.get("toy")
    scfg = dataclasses.replace(
        base, conformer=ConformerConfig(model_dim=128, num_layers=2, num_heads=2,
                                        ffn_inner_dim=256, depthwise_kernel_size=7),
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=128),
        model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256)
    enc = TorchSpeechEncoder(speech_encoder_from_numpy(init_speech_encoder_params(scfg, seed=0),
                                                       scfg, torch.bfloat16, device=dev),
                             device=dev)
    rng = np.random.default_rng(0)
    half, masked = ffn.BF16_LAUNCHES, beam_attend.MASKED_LAUNCHES
    dec.generate_beam(rng.normal(size=(2, 1, 128)).astype(np.float32), [3, 7],
                      BeamSearchConfig(beam_size=3, max_gen_len=6))
    enc.encode_waveforms([rng.normal(size=16000 * 3).astype(np.float32) * 0.1])
    torch.cuda.synchronize()
    assert ffn.BF16_LAUNCHES == half
    assert beam_attend.MASKED_LAUNCHES > masked


# The residual add + LayerNorm (csrc/add_layer_norm.cu): x_out bit for bit
# as the eager `x + s * f`; ln bit for bit as a mirror of the kernel's
# order of fp32 sums (per lane over its vectors, then the warp's xor
# butterfly; the rest of the eager path's roundings as they are). Against
# the eager path's ln, which differs only by the order of those sums: bf16
# within one bf16 ulp at the larger of the output and its terms (|v| +
# |mean|) rstd |w| + |b|; fp32 to max-abs 1e-5 (outputs of scale ~1-8; the
# two orders move the mean and the variance by a few fp32 ulps, so an
# output near a cancellation moves by more ulps of its own than one).


def _ulp(v, dtype):
    mant = 7 if dtype == torch.bfloat16 else 23
    a = v.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - mant)


def _add_ln_mirror(v, params, dtype):
    """LN of the fp32 rows ``v`` (the sums as T gives them) in the kernel's
    order: lane l sums its values of vectors l, l + 32, ... in turn, then
    the warp adds lanes l and l ^ o for o = 16 .. 1. -> (ln in ``dtype``,
    the scale of its terms)."""
    m, d = v.shape
    e = 16 // torch.empty((), dtype=dtype).element_size()
    vv = v.view(m, d // (32 * e), 32, e)
    lane = torch.arange(32, device=v.device)
    dd = torch.tensor(float(d), device=v.device)

    def mean_of(terms):
        s = torch.zeros(m, 32, device=v.device)
        for j in range(vv.shape[1]):
            for k in range(e):
                s = s + terms(vv[:, j, :, k])
        for o in (16, 8, 4, 2, 1):
            s = s + s[:, lane ^ o]
        return s[:, :1] / dd

    mean = mean_of(lambda t: t)
    rstd = torch.rsqrt(mean_of(lambda t: (t - mean) * (t - mean)) + 1e-5)
    w, b = params["weight"].float(), params["bias"].float()
    y = ((v - mean) * rstd) * w + b
    return y.to(dtype), (v.abs() + mean.abs()) * rstd * w.abs() + b.abs()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 7, 3184, 31984])
@pytest.mark.parametrize("d", [256, 1024, 2048])
@pytest.mark.parametrize("case", ["sum", "no_sum", "no_branch"])
def test_add_layer_norm_kernel(dev, dtype, m, d, case):
    """M 1 to the speech cell's 31,984 rows, D 256 to 2048, both dtypes,
    with and without x_out, without a branch; the parameters in x's dtype
    and (without x_out) in fp32."""
    x = _rand(dev, m, d, scale=2.0, dtype=dtype) + 0.25
    branch = None if case == "no_branch" else _rand(dev, m, d, scale=1.5, dtype=dtype, seed=1)
    pdt = torch.float32 if case == "no_sum" else dtype
    params = {"weight": (_rand(dev, d, scale=0.3, seed=2) + 1).to(pdt),
              "bias": _rand(dev, d, scale=0.2, seed=3).to(pdt)}
    res_scale = 0.5 if case == "sum" else 1.0
    got_sum, got_ln = _launched(layer_norm, lambda: layer_norm.add_layer_norm(
        x, branch, params, res_scale, want_sum=case != "no_sum"))
    want_sum, want_ln = layer_norm.add_layer_norm_plain(x, branch, params, res_scale)
    if case == "sum":
        assert got_sum.dtype == dtype and torch.equal(got_sum, want_sum)
    elif case == "no_sum":
        assert got_sum is None
    else:
        assert got_sum is x
    mirror, terms = _add_ln_mirror(want_sum.float(), params, dtype)
    assert got_ln.dtype == dtype and torch.equal(got_ln, mirror)
    diff = (got_ln.float() - want_ln.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-5
    else:
        assert (diff <= _ulp(torch.maximum(want_ln.float().abs(), terms), dtype)).all()


@pytest.mark.gpu
def test_add_layer_norm_raises_on_what_the_kernel_does_not_take(dev):
    def args(d, dtype=torch.bfloat16, pdt=None):
        return (_rand(dev, 8, d, dtype=dtype), _rand(dev, 8, d, dtype=dtype, seed=1),
                {"weight": _rand(dev, d, seed=2).to(pdt or dtype),
                 "bias": _rand(dev, d, seed=3).to(pdt or dtype)})

    for d in (96, 4096):
        with pytest.raises(ValueError):
            layer_norm.add_layer_norm(*args(d))
    x, branch, params = args(1024)
    with pytest.raises(ValueError):  # a non-contiguous x
        layer_norm.add_layer_norm(x.t().contiguous().t(), branch, params)
    with pytest.raises(ValueError):  # a dtype outside _KIND
        layer_norm.add_layer_norm(*args(1024, torch.float16))
    with pytest.raises(ValueError):  # a branch of another shape
        layer_norm.add_layer_norm(x, branch[:4], params)
    with pytest.raises(ValueError):  # fp32 x, bf16 parameters
        layer_norm.add_layer_norm(*args(1024, torch.float32, torch.bfloat16))


def _full_width_conformer(dev, dtype, layers):
    """``layers`` Conformer blocks of the ``english`` encoder's widths (D
    1024, 16 heads of 64, FFN 4096, kernel 31) from seeded numpy weights,
    their LayerNorms and batch-norm not the identity."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_speech_encoder_params
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn import conformer

    base = sonar_speech_encoder_archs.get("english")
    cfg = dataclasses.replace(base.conformer, num_layers=layers)
    tree = init_speech_encoder_params(dataclasses.replace(base, conformer=cfg),
                                      seed=0)["encoder"]["layers"]
    rng = np.random.default_rng(1)
    d = cfg.model_dim
    for name in conformer._LAYER_NORMS:
        tree[name] = {"weight": rng.uniform(0.5, 1.5, (layers, d)).astype(np.float32),
                      "bias": (rng.standard_normal((layers, d)) * 0.1).astype(np.float32)}
    tree["conv"]["batch_norm"]["running_var"] = rng.uniform(0.5, 1.5, (layers, d)).astype(
        np.float32)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node)).to(device=dev, dtype=dtype)

    return to_torch(tree), cfg


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_conformer_block_takes_add_layer_norm(dev, dtype, monkeypatch):
    """Two full-width Conformer blocks at [4, 300]: 5 launches of the
    residual add + LN a layer, #6's too, and the eager block's output at
    the #6 block tests' tolerance (cosine >= 0.9999 a row, max-abs within
    2e-2 of the scale); under autograd no launch, and a backward."""
    from sonar_tpu_torch.nn import conformer
    from sonar_tpu_torch.ops import masks

    stacked, cfg = _full_width_conformer(dev, dtype, 2)
    x = _rand(dev, 4, 300, 1024, dtype=dtype, seed=4)
    mask = masks.length_mask(torch.tensor([300, 251, 130, 7], device=dev), 300)
    bias = masks.additive_bias(mask)[:, None, None, :]
    with torch.inference_mode():
        before, rel = layer_norm.LAUNCHES, relpos_flash.LAUNCHES
        got = conformer.conformer_stack(stacked, x, bias, mask, cfg)
        torch.cuda.synchronize()
        assert layer_norm.LAUNCHES == before + 5 * 2
        assert relpos_flash.LAUNCHES == rel + 2
        monkeypatch.setattr(conformer, "_use_add_ln_kernel", lambda *a: False)
        want = conformer.conformer_stack(stacked, x, bias, mask, cfg)
        assert layer_norm.LAUNCHES == before + 5 * 2
        monkeypatch.undo()
    rows = mask.reshape(-1)
    _assert_close(got.reshape(-1, 1024), want.reshape(-1, 1024), rows=rows)
    scale = want.float()[mask].abs().max().item()
    assert (got.float() - want.float())[mask].abs().max().item() <= 2e-2 * scale
    leaves = [t.requires_grad_(True) for t in (stacked["layer_norm"]["weight"],
                                                stacked["ffn1"]["inner_proj"]["kernel"])]
    before = layer_norm.LAUNCHES
    out = conformer.conformer_stack(stacked, x, bias, mask, cfg)
    out.float().square().mean().backward()
    torch.cuda.synchronize()
    assert layer_norm.LAUNCHES == before
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.gpu
def test_sampling_card_matches_cpu(dev):
    """Top-p sampling of a small decoder on the card and on the CPU, the
    same Gumbel noise given to both through the ``noise`` hook: the same
    tokens and lengths, scores to 1e-4 (fp32, other summation orders)."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    params = init_text_decoder_params(cfg, seed=0)
    memory = np.random.default_rng(0).normal(size=(4, 1, 128)).astype(np.float32) * 2.0
    gen = torch.Generator().manual_seed(0)
    draws = [-torch.log(-torch.log(torch.rand(4, 3000, generator=gen).clamp_min(1e-38)))
             for _ in range(12)]
    sampler = TopPSampler(0.9, max_candidates=64)
    out = [TorchTextDecoder(text_decoder_from_numpy(params, cfg, device=d), device=d)
           .generate_sample(memory, [3, 7], sampler, max_gen_len=10,
                            noise=lambda step, shape: draws[step])
           for d in (dev, "cpu")]
    (ct, cs, cl), (pt, ps, pl) = out
    np.testing.assert_array_equal(ct, pt)
    np.testing.assert_array_equal(cl, pl)
    np.testing.assert_allclose(cs, ps, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "int8"])
def test_cosine_topk_on_the_card(dev, mode):
    """Mining's product and selection on the card against the same call on
    the CPU: fp32 scores within 1e-5 and indices equal but in rows with a
    tie or near tie (two of the CPU's top k + 1 within 1e-6, which the two
    GEMMs' sums may order either way); int8 (the codes are the same bits on
    both, the int32 sums exact) scores and indices identical."""
    from sonar_tpu_torch.parallel import mining

    gen = torch.Generator().manual_seed(7)
    bank = torch.randn(5000, 256, generator=gen)
    bank[4000:4100] = bank[:100]  # duplicated rows: exact ties
    queries = torch.cat([bank[torch.randperm(5000, generator=gen)[:200]]
                         + 0.5 * torch.randn(200, 256, generator=gen),
                         torch.randn(312, 256, generator=gen)])
    dot = "int8" if mode == "int8" else None
    got_s, got_i = mining.cosine_topk(queries, bank, 8, block_size=1024, dot_dtype=dot,
                                      device=dev)
    want_s, want_i = mining.cosine_topk(queries, bank, 8, block_size=1024, dot_dtype=dot,
                                        device="cpu")
    got_s, got_i = got_s.cpu(), got_i.cpu()
    if mode == "int8":
        assert torch.equal(got_i, want_i) and torch.equal(got_s, want_s)
        return
    assert (got_s - want_s).abs().max().item() <= 1e-5
    ref, _ = mining.cosine_topk(queries, bank, 9, block_size=1024, device="cpu")
    near = (-ref.diff(dim=1) <= 1e-6).any(dim=1)  # duplicated rows tie exactly on the CPU
    assert torch.equal(got_i[~near], want_i[~near]) and near.sum().item() <= 128


# -- packed encoding and serving ---------------------------------------------------


def _packed_bias(dev, b, s, seed):
    """A block-diagonal bias of packed rows [b, 1, s, s] as ``apply_packed``
    builds it: segments of 1 to s/3 tokens, a padded tail in each row
    (positions of segment 0, every key masked) and the last row padding
    from start to end."""
    rng = torch.Generator().manual_seed(seed)
    seg = torch.zeros(b, s, dtype=torch.int32)
    for row in range(b - 1):
        pos, sid = 0, 1
        while True:
            n = int(torch.randint(1, max(2, s // 3), (1,), generator=rng))
            if pos + n > s - 5:
                break
            seg[row, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    seg = seg.to(dev)
    real = seg > 0
    keep = (seg[:, :, None] == seg[:, None, :]) & real[:, :, None] & real[:, None, :]
    return torch.where(keep, 0.0, F32_MIN)[:, None].float(), real


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 130, 512])
def test_flash_kernel_packed_full_bias(dev, dtype, s):
    """Mode 2 (a full bias) on packed rows: every padding position is a
    query whose keys are all masked, and the last row is wholly padding.
    The output is finite everywhere (the uniform softmax of ``finfo.min``
    logits, as the plain version and JAX give), agrees with the plain
    version on every row, and two calls give the same bits."""
    b = 4
    q, k, v = (_rand(dev, b, 2, s, 64, dtype=dtype, seed=10 + i) for i in range(3))
    bias, real = _packed_bias(dev, b, s, seed=s)
    assert (~real).all(dim=1)[-1] and (~real[:-1]).any()
    got = _launched(flash, lambda: flash.flash_attention(q, k, v, bias))
    want = flash.flash_attention_plain(q, k, v, bias)
    assert torch.isfinite(got.float()).all() and torch.isfinite(want.float()).all()
    _assert_close(got, want)
    assert torch.equal(flash.flash_attention(q, k, v, bias), got)


def _wide_text_model(dtype, device):
    import dataclasses

    from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    cfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), model_dim=128,
                              num_encoder_attn_heads=2, ffn_inner_dim=512)
    return text_encoder_from_numpy(init_text_encoder_params(cfg, seed=1), cfg, dtype, device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_apply_packed_on_the_card(dev, mode):
    """Packed rows of 128 (16 rows: the int8 FFN's gate) through
    ``apply_packed`` on the card and on the CPU: flash in full-bias mode
    launches (and the int8 FFN in int8), every output is finite, each
    filled slot's cosine >= 0.999 against the CPU."""
    from sonar_tpu_torch.data.packing import pack_sequences
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.ops.precision import matmul_precision_for

    rng = torch.Generator().manual_seed(3)
    sents = [torch.randint(4, 1000, (int(n),), generator=rng).tolist()
             for n in torch.randint(2, 60, (50,), generator=rng)]
    batch = next(pack_sequences(sents, row_len=128, rows_per_batch=16, max_segments=8))
    assert (batch.segment_ids == 0).all(axis=1).any()
    outs = {}
    for device in (dev, "cpu"):
        model = TorchTextEncoder(_wide_text_model(torch.bfloat16, device),
                                 quantize=mode == "int8", device=device).model
        args = [torch.from_numpy(a).to(device)
                for a in (batch.tokens, batch.segment_ids, batch.positions)]
        before = flash.LAUNCHES, ffn.LAUNCHES
        with torch.inference_mode(), matmul_precision_for(model.dtype):
            outs[str(device)] = model.apply_packed(model.params.tree(), *args, 8).cpu()
        torch.cuda.synchronize()
        if device == dev:
            assert flash.LAUNCHES > before[0]
            assert (ffn.LAUNCHES > before[1]) == (mode == "int8")
    got, want = outs[str(dev)], outs["cpu"]
    assert torch.isfinite(got).all()
    filled = torch.zeros(got.shape[:2], dtype=torch.bool)
    for _, row, seg in batch.mapping:
        filled[row, seg - 1] = True
    assert (got[~filled] == 0).all()
    cos = torch.nn.functional.cosine_similarity(got[filled].double(), want[filled].double(), -1)
    assert cos.min().item() >= 0.999


@pytest.mark.gpu
def test_server_round_trip_on_the_card(dev, tmp_path):
    """One /embed request through the port's server and client on the card
    equals the pipeline's direct static ``predict`` bit for bit (the same
    batch) and the CPU's within 1e-3 of the embeddings' scale (fp32)."""
    import numpy as np

    from sonar_tpu_torch.client import SonarClient
    from sonar_tpu_torch.inference_pipelines.text import TextToEmbeddingModelPipeline
    from sonar_tpu_torch.serving import EmbeddingServer
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
    from sonar_tpu_torch.tokenizers.spm_proto import (
        PIECE_CONTROL, PIECE_UNKNOWN, ModelProto, NormalizerSpecProto, SentencePieceProto as P,
        TrainerSpecProto, serialize_model_proto)

    pieces = [P("<blank>", 0.0, PIECE_CONTROL), P("<unk>", 0.0, PIECE_UNKNOWN),
              P("<s>", 0.0, PIECE_CONTROL), P("</s>", 0.0, PIECE_CONTROL)]
    pieces += [P("▁" + w, -1.0) for w in ("hello", "world", "the", "cat", "sat")]
    pieces += [P(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz"] + [P("▁", -4.0)]
    path = tmp_path / "t.model"
    path.write_bytes(serialize_model_proto(ModelProto(
        pieces=pieces, trainer=TrainerSpecProto(unk_id=1, bos_id=2, eos_id=3, pad_id=1),
        normalizer=NormalizerSpecProto())))
    tok = NllbTokenizer(path, langs=["eng_Latn"], default_lang="eng_Latn")
    texts = ["hello world", "the cat sat on the mat " * 30, "cat"]
    pipe = TextToEmbeddingModelPipeline(_wide_text_model(torch.float32, dev), tok, device=dev)
    srv = EmbeddingServer(pipe, max_wait_ms=1, warmup=True).start()
    try:
        with SonarClient(*srv.address, timeout_s=120) as client:
            got = client.embed(texts)
            assert client.metrics()["embed"]["errors"] == 0
    finally:
        srv.stop()
    direct = pipe.predict(texts, source_lang="eng_Latn", batching="static")
    assert np.array_equal(got, direct)
    cpu = TextToEmbeddingModelPipeline(_wide_text_model(torch.float32, "cpu"), tok,
                                       device="cpu").predict(texts, source_lang="eng_Latn",
                                                             batching="static")
    assert np.abs(got - cpu).max() <= 1e-3 * np.abs(cpu).max()


# -- training ------------------------------------------------------------------------


def _all_launches():
    return (short_attn.LAUNCHES, flash.LAUNCHES, attn_block.LAUNCHES, ffn.LAUNCHES,
            ffn.BF16_LAUNCHES, relpos_flash.LAUNCHES, relpos_flash.V1_LAUNCHES,
            beam_attend.MASKED_LAUNCHES, beam_attend.DIAG_LAUNCHES,
            beam_attend.REORDER_LAUNCHES, layer_norm.LAUNCHES)


def _wide_translation(dtype, device, s):
    """A D 128 (two heads of 64) encoder and decoder with fused q/k/v, their
    trees as fp32 leaves on ``device``, and a batch at source length ``s``
    (40: the short-attention gate; 300: flash's) and target length 24."""
    import dataclasses

    from sonar_tpu_torch.assets.convert import (
        init_text_decoder_params, init_text_encoder_params, text_decoder_from_numpy,
        text_encoder_from_numpy)
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs
    from sonar_tpu_torch.nn.transformer import fuse_qkv

    wide = dict(model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
                ffn_inner_dim=256)
    ecfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), **wide)
    dcfg = dataclasses.replace(sonar_text_decoder_archs.get("toy"), **wide)
    enc_np, dec_np = init_text_encoder_params(ecfg, seed=2), init_text_decoder_params(dcfg, seed=3)
    encoder = text_encoder_from_numpy(enc_np, ecfg, dtype, device)
    decoder = text_decoder_from_numpy(dec_np, dcfg, dtype, device)
    params = {"encoder": fuse_qkv(text_encoder_from_numpy(enc_np, ecfg, device=device)
                                  .params.tree(), keep_split=False),
              "decoder": fuse_qkv(text_decoder_from_numpy(dec_np, dcfg, device=device)
                                  .params.tree(), keep_split=False)}
    gen = torch.Generator().manual_seed(s)
    batch = {"src_tokens": torch.randint(4, 1000, (4, s), generator=gen),
             "src_lens": torch.tensor([s, s - 7, s // 2, 3]),
             "tgt_in": torch.randint(4, 1000, (4, 24), generator=gen),
             "tgt_out": torch.randint(4, 1000, (4, 24), generator=gen),
             "tgt_lens": torch.tensor([24, 20, 9, 1])}
    return encoder, decoder, params, {k: v.to(device) for k, v in batch.items()}


def _translation_grads(dtype, device, s):
    from sonar_tpu_torch.training import train_step as ts

    encoder, decoder, params, batch = _wide_translation(dtype, device, s)
    state = ts.init_train_state(params, lambda leaves: torch.optim.SGD(leaves, lr=0.0))
    before = _all_launches()
    step = ts.make_train_step(lambda p, b, g: ts.translation_loss(
        encoder, decoder, p["encoder"], p["decoder"], b, g))
    _, loss = step(state, batch)
    if device != "cpu":
        torch.cuda.synchronize()
        assert _all_launches() == before  # no kernel while autograd records
    return float(loss), {path: t.grad.cpu() for path, t in _leaves(params)}


def _leaves(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}/{key}")
        else:
            yield f"{prefix}/{key}", value


@pytest.mark.gpu
@pytest.mark.parametrize("s", [40, 300])
def test_training_step_card_matches_cpu(dev, s):
    """One fp32 ``translation_loss`` step on the card and on the CPU, the
    same weights and batch, dropout off: the loss within 1e-5 of the CPU's,
    every gradient leaf within 1e-4 of the larger of its scale and a
    thousandth of the largest leaf's, and no kernel launched (the shapes
    reach the short-attention and flash gates). The cross-attention's q and
    k projections have a zero gradient in exact arithmetic (a softmax over
    one memory row is 1): both sides must read them zero at that
    resolution."""
    loss, grads = _translation_grads(torch.float32, dev, s)
    want_loss, want = _translation_grads(torch.float32, "cpu", s)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    top = max(g.abs().max().item() for g in want.values())
    for path, w in want.items():
        if "/encoder_decoder_attn/q_proj/" in path or "/encoder_decoder_attn/k_proj/" in path:
            assert max(grads[path].abs().max().item(), w.abs().max().item()) <= 1e-4 * top, path
            continue
        scale = max(w.abs().max().item(), 1e-3 * top)
        assert (grads[path] - w).abs().max().item() <= 1e-4 * scale, path


@pytest.mark.gpu
def test_training_step_bf16_on_the_card(dev):
    """A bf16 step on fp32 leaves: no kernel launched, every gradient finite,
    and the tied projection's backward (``matmul_f32_out`` on the card)
    against the fp32 product's: cosine >= 0.999."""
    from sonar_tpu_torch.ops.precision import matmul_f32_out

    loss, grads = _translation_grads(torch.bfloat16, dev, 40)
    assert loss == loss and all(bool(torch.isfinite(g).all()) for g in grads.values())
    a = _rand(dev, 96, 128, dtype=torch.bfloat16, seed=1).requires_grad_(True)
    b = _rand(dev, 128, 3000, dtype=torch.bfloat16, seed=2).requires_grad_(True)
    g = _rand(dev, 96, 3000, seed=3)
    (matmul_f32_out(a, b) * g).sum().backward()
    a32, b32 = a.detach().float().requires_grad_(True), b.detach().float().requires_grad_(True)
    ((a32 @ b32) * g).sum().backward()
    for got, want in ((a.grad, a32.grad), (b.grad, b32.grad)):
        cos = torch.nn.functional.cosine_similarity(got.float().flatten(), want.flatten(), 0)
        assert got.dtype == torch.bfloat16 and cos.item() >= 0.999


@pytest.mark.gpu
def test_frozen_encoder_launches_kernels(dev):
    """``classifier_loss`` with the encoder frozen runs its forward under
    ``no_grad``: the short-attention kernel launches (S 40, fused q/k/v),
    the head gets gradients, the encoder none."""
    from sonar_tpu_torch.assets.convert import init_mutox_params, mutox_from_numpy
    from sonar_tpu_torch.models.mutox import MutoxConfig
    from sonar_tpu_torch.nn.core import tree_leaves
    from sonar_tpu_torch.training import train_step as ts

    encoder, _, params, batch = _wide_translation(torch.bfloat16, dev, 40)
    head_np = init_mutox_params(MutoxConfig(128), seed=0)
    head = mutox_from_numpy(head_np, MutoxConfig(128), device=dev)
    tree = {"encoder": params["encoder"], "head": head.params.tree()}
    for t in tree_leaves(tree):
        t.requires_grad_(True)
    before = short_attn.LAUNCHES
    loss = ts.classifier_loss(encoder, head, tree, {
        "tokens": batch["src_tokens"], "lens": batch["src_lens"],
        "labels": torch.tensor([0, 1, 1, 0], device=dev)})
    loss.backward()
    torch.cuda.synchronize()
    assert short_attn.LAUNCHES > before
    assert all(t.grad is None for t in tree_leaves(tree["encoder"]))
    assert all(t.grad is not None for t in tree_leaves(tree["head"]))


@pytest.mark.gpu
def test_relpos_after_a_step_on_the_card(dev, monkeypatch):
    """A D 128 speech encoder serves an inference forward at S 150, takes
    one Adam step on the card (r_proj changes), and serves again: the
    rel-pos v2 kernel launches and agrees with the plain path (fp32, cosine
    >= 0.9999 a row)."""
    import dataclasses

    from sonar_tpu_torch.assets.convert import init_speech_encoder_params, speech_encoder_from_numpy
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn import conformer
    from sonar_tpu_torch.training import train_step as ts

    base = sonar_speech_encoder_archs.get("toy")
    cfg = dataclasses.replace(
        base, conformer=conformer.ConformerConfig(model_dim=128, num_layers=2, num_heads=2,
                                                  ffn_inner_dim=256, depthwise_kernel_size=7),
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=128),
        model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256)
    model = speech_encoder_from_numpy(init_speech_encoder_params(cfg, seed=0), cfg, device=dev)
    gen = torch.Generator().manual_seed(0)
    fb = torch.randn(2, 300, 80, generator=gen).to(dev)
    lens = torch.tensor([300, 260], device=dev)
    batch = {"inputs": fb, "lens": lens, "teacher_emb": torch.randn(2, 128, generator=gen).to(dev)}
    with torch.inference_mode():
        model(fb, lens)
    state = ts.init_train_state(model.params.tree(),
                                lambda leaves: torch.optim.Adam(leaves, lr=0.05))
    before = _all_launches()
    ts.make_train_step(lambda p, b, g: ts.distillation_loss(model, p, b))(state, batch)
    torch.cuda.synchronize()
    assert _all_launches() == before
    with torch.inference_mode():
        launches = relpos_flash.LAUNCHES
        got = model(fb, lens).sentence_embeddings
        torch.cuda.synchronize()
        assert relpos_flash.LAUNCHES == launches + 2
        monkeypatch.setattr(conformer, "_use_relpos_kernel", lambda *a: False)
        want = model(fb, lens).sentence_embeddings
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [False, True], ids=["bf16", "int8"])
def test_world_one_nccl_mesh_encode_is_the_mesh_free_encode(dev, tmp_path, quantize):
    """``TorchTextEncoder(mesh=make_mesh(1, 1))`` in a one-rank NCCL group
    gives the mesh-free encode bit for bit, with the same kernel launches
    (D 128, 2 heads, FFN 512; [32, 64] tokens reach #1 or #2 and #3)."""
    import dataclasses

    import numpy as np
    import torch.distributed as dist

    from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
    from sonar_tpu_torch.data.collate import SequenceBatch
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
    from sonar_tpu_torch.parallel import initialize, make_mesh

    cfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), model_dim=128,
                              num_encoder_attn_heads=2, ffn_inner_dim=512)
    model = text_encoder_from_numpy(init_text_encoder_params(cfg, 0), cfg, torch.bfloat16, dev)
    rng = np.random.default_rng(0)
    seqs = rng.integers(4, cfg.vocab_info.size, (32, 64)).astype(np.int32)
    lens = rng.integers(1, 65, (32,)).astype(np.int32)
    batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=32)
    counters = (short_attn, "LAUNCHES"), (attn_block, "LAUNCHES"), (ffn, "LAUNCHES")

    def run(mesh):
        before = [getattr(m, c) for m, c in counters]
        out = TorchTextEncoder(model, quantize=quantize, device=dev, mesh=mesh).encode_batch(batch)
        torch.cuda.synchronize()
        return out, [getattr(m, c) - b for (m, c), b in zip(counters, before)]

    want, want_launches = run(None)
    initialize(f"file://{tmp_path / 'rendezvous'}", rank=0, world_size=1, backend="nccl")
    try:
        got, launches = run(make_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    assert sum(want_launches) > 0 and launches == want_launches
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_captured_beam_decode_matches_the_eager_body(dev, mode):
    """Beam decode through the captured CUDA graphs and the device-side
    loop (``generate_beam`` and the async pair) against the eager body on
    the card (``_beam_eager``, the same padded batch): tokens and lengths
    identical, scores within 1e-5 (bit for bit unless cuBLAS picks another
    algorithm under capture). The card runs the search's steps and no
    more (the first call adds the prefix's and one body step, run eagerly
    before the capture); ``beam_masked_attend`` launches 2 layers x the
    steps the card ran; the second call replays the same program."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    dec = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg,
                                                   dtype, device=dev),
                           quantize=mode == "int8", device=dev)
    rng = np.random.default_rng(0)
    memory = rng.normal(size=(5, 1, 128)).astype(np.float32) * 2.0
    config = BeamSearchConfig(beam_size=3, max_gen_len=12, len_penalty=0.7, unk_penalty=0.5)
    search = dec._search_config(config, 2)
    want = dec._beam_eager(torch.tensor(memory, device=dev), [3, 7], search)
    for run in range(2):
        masked, steps, ran = beam_attend.MASKED_LAUNCHES, dec.decode_steps, dec.device_steps
        handle = dec.generate_beam_async(memory, [3, 7], config)
        got = dec.materialize_beam(handle)
        torch.cuda.synchronize()
        assert len(dec._graphs) == 1
        warm = 3 if run == 0 else 0
        assert dec.device_steps - ran == dec.decode_steps - steps + warm
        assert dec.decode_steps - steps > 2
        assert beam_attend.MASKED_LAUNCHES - masked == 2 * (dec.device_steps - ran)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_beam_decode_from_several_threads(dev):
    """Four threads decode on one decoder at once, each three batches of 3, 5
    and 9 rows (padded to 4, 8 and 16: three captures race with the other
    threads' dispatches), half through the async pair, with a short switch
    interval: every result equals the same call made alone on a second
    decoder of the same weights, and every thread ends within 300 s."""
    import dataclasses
    import sys
    import threading

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    model = text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg, torch.bfloat16,
                                    device=dev)
    shared, alone = TorchTextDecoder(model, device=dev), TorchTextDecoder(model, device=dev)
    config = BeamSearchConfig(beam_size=3, max_gen_len=10)
    rng = np.random.default_rng(0)
    jobs = [[rng.normal(size=(b, 1, 128)).astype(np.float32) for b in (3, 5, 9)]
            for _ in range(4)]
    got, errors = {}, []

    def run(t):
        try:
            for i, mem in enumerate(jobs[t]):
                if (t + i) % 2:
                    got[t, i] = shared.generate_beam(mem, [3, 7], config)
                else:
                    got[t, i] = shared.materialize_beam(
                        shared.generate_beam_async(mem, [3, 7], config))
        except Exception as err:  # reported below with its thread
            errors.append((t, err))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert len(got) == 12 and len(shared._graphs) == 3
    for (t, i), out in got.items():
        want = alone.generate_beam(jobs[t][i], [3, 7], config)
        for g, w in zip(out, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("start", [0, 7, 10])
def test_while_graph_runs_its_body_until_done(dev, start):
    """``ops.cuda.graph_loop.WhileGraph`` loops a captured body (a cuBLAS
    product and a counter) on the card until the body writes done: from a
    count of 0 and 7 it runs to 10 steps, equal bit for bit to 10 eager
    steps; from 10 (done at launch) it runs none. Launched twice, it runs
    again."""
    from sonar_tpu_torch.ops.cuda.graph_loop import WhileGraph

    gen = torch.Generator(device="cpu").manual_seed(0)
    x0 = torch.randn(64, 64, generator=gen).to(dev, torch.bfloat16)
    w = (torch.randn(64, 64, generator=gen) * 0.1).to(dev, torch.bfloat16)
    x = x0.clone()
    count = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        x.copy_(torch.tanh(x @ w))
        count.add_(1)
        done.copy_(count >= 10)

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        body()
    loop = WhileGraph(graph, done)
    want = x0.clone()
    for _ in range(10 - start):
        want = torch.tanh(want @ w)
    for _ in range(2):
        x.copy_(x0)
        count.fill_(start)
        done.fill_(start >= 10)
        loop.launch(torch.cuda.current_stream(dev))
        torch.cuda.synchronize()
        assert int(count) == max(start, 10)
        assert torch.equal(x, want)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [32, 128])
def test_gumbel_max_kernel_is_the_plain_draw(dev, b):
    """``gumbel_max`` at [B, 256206] (the ``basic`` decoder's vocabulary)
    over 48 steps, on top-p-filtered rows (most columns -1e30) and on whole
    log-probability rows in turns, rows offset by a ``row0`` of 0 to 2: the
    noise equal to the plain version's bit for bit, the tokens equal; one
    launch a call."""
    from sonar_tpu_torch.generation.sampling import TopPSampler
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm

    v = 256206
    lp = torch.log_softmax(_rand(dev, b, v, scale=3.0), dim=-1)
    nucleus = TopPSampler(0.9).filter_logprobs(lp)
    key = gm.prng_key(123456, dev)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    noise, want_noise = (torch.empty(b, v, device=dev) for _ in range(2))
    before = gm.LAUNCHES
    for s in range(48):
        step.fill_(s)
        filtered = nucleus if s % 2 else lp
        got = gm.gumbel_max(filtered, key, step, row0=s % 3, noise=noise)
        want = gm.gumbel_max_plain(filtered, key, step, s % 3, noise=want_noise)
        torch.cuda.synchronize()
        assert torch.equal(noise, want_noise), s
        assert got.dtype == torch.int64 and torch.equal(got, want), s
    assert gm.LAUNCHES - before == 48


@pytest.mark.gpu
def test_gumbel_max_kernel_raises_on_what_it_does_not_take(dev):
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm

    x = torch.zeros(4, 100, device=dev)
    key, step = gm.prng_key(0, dev), torch.zeros((), dtype=torch.int64, device=dev)
    for args in ((x.half(), key, step), (x, key.int(), step), (x, key, step.int()),
                 (x, key.cpu(), step), (x[:, ::2], key, step), (x[0], key, step)):
        with pytest.raises(ValueError):
            gm.gumbel_max(*args)
    with pytest.raises(ValueError):
        gm.gumbel_max(x, key, step, row0=-1)


class _FlatSampler:
    """A test sampler whose filter keeps every column at 0 but EOS (NEG_INF,
    so that no row stops): each token is a uniform draw of the vocabulary,
    which a draw fixed at capture would repeat at every step."""

    temperature = 1.0

    def __init__(self, eos):
        self.eos = eos

    def filter_logprobs(self, lp):
        out = torch.zeros_like(lp)
        out[:, self.eos] = -1e30
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_captured_sampling_matches_the_eager_body(dev, mode):
    """Sampling through the captured setup and step looped on the card
    (``generate_sample``) against the eager body on the card
    (``_sample_eager``, the same padded batch and seed; the memory rows of
    a 2-D array): tokens, scores and lengths bit for bit, top-p with
    min_gen_len 3 and top-k at temperature 0.7. The card runs the loop's
    steps and no more (the first call adds the prefix's and one body step,
    run eagerly before the capture);
    ``gumbel_max`` launches once a body step the card ran; the second call
    replays; another seed samples other tokens. Then the fresh-noise check:
    12 steps of a flat filter give each row at least 10 distinct tokens."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler, TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    dec = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg,
                                                   dtype, device=dev),
                           quantize=mode == "int8", device=dev)
    # Rows of a 2-D array with an axis added (stride 0 on it), as a caller
    # slices embeddings: the eager body takes them as they are.
    rows = np.random.default_rng(0).normal(size=(5, 128)).astype(np.float32) * 2.0
    memory = rows[:, None, :]
    mem = torch.as_tensor(memory, device=dev)
    for sampler, min_len in ((TopPSampler(0.9), 3), (TopKSampler(10, temperature=0.7), 1)):
        want = dec._sample_eager(mem, [3, 7], sampler, 12, min_len, seed=5)
        for run in range(2):
            launches, steps, ran = gm.LAUNCHES, dec.decode_steps, dec.device_steps
            got = dec.generate_sample(memory, [3, 7], sampler, 12, min_len, seed=5)
            warm = 3 if run == 0 else 0
            assert dec.device_steps - ran == dec.decode_steps - steps + warm
            body = dec.decode_steps - steps - 2
            assert body > 0 and gm.LAUNCHES - launches == body + (1 if run == 0 else 0)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        other = dec.generate_sample(memory, [3, 7], sampler, 12, min_len, seed=6)
        assert not np.array_equal(other[0], want[0])
    assert len(dec._graphs) == 2
    flat = dec.generate_sample(np.zeros((32, 1, 128), np.float32), [3, 7],
                               _FlatSampler(cfg.vocab_info.eos_idx), 12, seed=1)
    assert (flat[2] == 13).all()
    assert min(len(set(row[:12].tolist())) for row in flat[0]) >= 10


@pytest.mark.gpu
def test_sampling_from_a_seed_card_matches_cpu(dev):
    """Top-p sampling from a seed, no hook, on the card (the captured
    program) and on the CPU (the plain draw): the same tokens and lengths,
    scores to 1e-4 (fp32, other summation orders)."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopPSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    params = init_text_decoder_params(cfg, seed=0)
    memory = np.random.default_rng(0).normal(size=(3, 1, 128)).astype(np.float32) * 2.0
    sampler = TopPSampler(0.9, max_candidates=64)
    (ct, cs, cl), (pt, ps, pl) = [
        TorchTextDecoder(text_decoder_from_numpy(params, cfg, device=d), device=d)
        .generate_sample(memory, [3, 7], sampler, max_gen_len=10, seed=9)
        for d in (dev, "cpu")]
    np.testing.assert_array_equal(ct, pt)
    np.testing.assert_array_equal(cl, pl)
    np.testing.assert_allclose(cs, ps, atol=1e-4)


# -- the kernel-selection scope on the captured decodes ------------------------------------------


def _scope_decoder(dev):
    """A fp32 D 128 decoder (two heads of 64) over 3000 rows on the card, and
    its beam and top-k sampling decodes of 5 rows."""
    import dataclasses

    import numpy as np

    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.generation.sampling import TopKSampler
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    toy = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2,
                              num_decoder_attn_heads=2, ffn_inner_dim=256,
                              vocab_info=dataclasses.replace(toy.vocab_info, size=3000))
    dec = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg,
                                                   device=dev), device=dev)
    memory = np.random.default_rng(0).normal(size=(5, 1, 128)).astype(np.float32) * 2.0
    config = BeamSearchConfig(beam_size=3, max_gen_len=12)
    return dec, {
        "beam": lambda: dec.generate_beam(memory, [3, 7], config),
        "sample": lambda: dec.generate_sample(memory, [3, 7], TopKSampler(10), 12, seed=5),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["beam", "sample"])
def test_decoder_captures_once_per_kernel_setting(dev, kind):
    """Three decodes on one runtime: outside ``no_cuda_kernels()``, inside it,
    outside again. Two captures (the second keyed on the scope), and the
    third call replays the first's (the same graph, no eager steps before a
    capture); the first and third equal bit for bit, the second the same
    tokens and lengths (the plain #8 and draw), scores within 1e-5."""
    import numpy as np

    from sonar_tpu_torch.ops.gates import no_cuda_kernels

    dec, decodes = _scope_decoder(dev)
    first = decodes[kind]()
    (key,) = list(dec._graphs)
    graph = dec._graphs[key]
    with no_cuda_kernels():
        second = decodes[kind]()
    assert len(dec._graphs) == 2 and key in dec._graphs
    warm = dec.device_steps - dec.decode_steps
    third = decodes[kind]()
    assert len(dec._graphs) == 2 and dec._graphs[key] is graph
    assert dec.device_steps - dec.decode_steps == warm
    for a, b in zip(first, third):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(second[0], first[0])
    np.testing.assert_array_equal(second[2], first[2])
    np.testing.assert_allclose(second[1], first[1], rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_no_launch_under_the_scope(dev):
    """A beam and a sampling decode inside ``no_cuda_kernels()`` launch no
    kernel (their captures tally none); the same decodes outside launch
    #8 and ``gumbel_max``."""
    from sonar_tpu_torch.ops.cuda import gumbel_max as gm
    from sonar_tpu_torch.ops.gates import no_cuda_kernels

    dec, decodes = _scope_decoder(dev)
    before = _all_launches() + (gm.LAUNCHES,)
    with no_cuda_kernels():
        decodes["beam"]()
        decodes["sample"]()
    torch.cuda.synchronize()
    assert _all_launches() + (gm.LAUNCHES,) == before
    assert all(not g.setup_launches and not g.step_launches for g in dec._graphs.values())
    masked, draws = beam_attend.MASKED_LAUNCHES, gm.LAUNCHES
    decodes["beam"]()
    decodes["sample"]()
    assert beam_attend.MASKED_LAUNCHES > masked and gm.LAUNCHES > draws


# -- NLLB-MoE: the expert layer and the translation program on the card -------------


def _moe_params(dev, d=256, f=512, experts=16, held=4, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def r(*shape, s=0.05):
        return (torch.randn(*shape, generator=g) * s).to(torch.bfloat16).to(dev)

    ids = torch.arange(experts)
    return {"router": {"kernel": r(d, experts, s=0.1)},
            "expert_slot": torch.where(ids < held, ids, held).int().to(dev),
            "inner_proj": {"kernel": r(held, d, f), "bias": r(held, f)},
            "output_proj": {"kernel": r(held, f, d), "bias": r(held, d)}}


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [1, 40, 640])
def test_moe_grouped_gemm_matches_the_cpu_layer(dev, tokens):
    """The expert layer's grouped GEMMs on the card against its plain groups
    on the CPU (the same bf16 weights), over the tokens both route alike (a
    near-tie of the fp32 router may flip on the other summation order); a
    token with no held expert gets exactly 0."""
    from sonar_tpu_torch.nn import moe

    params = _moe_params(dev)
    x = _rand(dev, tokens, 256, dtype=torch.bfloat16)
    with torch.inference_mode():
        got = moe.moe_ffn(params, x)
        cpu = {k: ({kk: vv.cpu().float() for kk, vv in v.items()} if isinstance(v, dict)
                   else v.cpu()) for k, v in params.items()}
        want = moe.moe_ffn(cpu, x.cpu().float())
        ids, _ = moe.route(params["router"], x)
        ids_cpu, _ = moe.route(cpu["router"], x.cpu().float())
    same = (ids.cpu() == ids_cpu).all(dim=-1)
    assert same.float().mean() >= 0.99
    held = (ids_cpu < 4).any(dim=-1) & same
    assert (got.cpu()[same & ~held] == 0).all()
    if held.any():
        _assert_close(got.cpu(), want, rows=held)


@pytest.mark.gpu
def test_moe_layer_is_captured_and_replays_new_inputs(dev):
    """Nothing of the routing is read on the host: the layer is captured in a
    CUDA graph and a replay on new tokens gives the eager layer's output."""
    from sonar_tpu_torch.nn import moe

    params = _moe_params(dev)
    x = _rand(dev, 320, 256, dtype=torch.bfloat16)
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe.moe_ffn(params, x)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = moe.moe_ffn(params, x)
        x.copy_(_rand(dev, 320, 256, dtype=torch.bfloat16, seed=9))
        graph.replay()
        want = moe.moe_ffn(params, x)
    torch.testing.assert_close(y, want, atol=0, rtol=0)
