"""The residual add + LayerNorm of the Conformer block on CPU
(``ops.cuda.layer_norm``): the plain version is the eager composition bit
for bit, the wrapper runs it for CPU tensors, the kernel's gate, and
``conformer_block`` returns exactly what the block's expression (the JAX
block's, ``sonar_tpu/nn/conformer.py``) returns. The kernel itself runs on
the card only (``test_torch_port_gpu.py``)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sonar_tpu_torch.nn import conformer  # noqa: E402
from sonar_tpu_torch.nn.core import layer_norm  # noqa: E402
from sonar_tpu_torch.ops.cuda import layer_norm as aln  # noqa: E402
from sonar_tpu_torch.ops.gates import no_cuda_kernels  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16]


def _rand(*shape, dtype=torch.float32, seed=0, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen) * scale).to(dtype)


def _ln_params(d, dtype, seed=0):
    return {"weight": (1.0 + _rand(d, seed=seed, scale=0.2)).to(dtype),
            "bias": _rand(d, seed=seed + 1, scale=0.1).to(dtype)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("res_scale", [0.5, 1.0])
@pytest.mark.parametrize("with_branch", [True, False])
def test_plain_is_the_eager_composition(dtype, res_scale, with_branch):
    """``add_layer_norm_plain`` and the wrapper on CPU tensors give the
    block's expression, ``x + 0.5 * f`` (``x + f`` at 1.0) then
    ``layer_norm``, bit for bit, and launch nothing."""
    x = _rand(4, 37, 256, dtype=dtype, seed=1)
    branch = _rand(4, 37, 256, dtype=dtype, seed=2, scale=3.0) if with_branch else None
    params = _ln_params(256, dtype)
    if branch is None:
        want_sum = x
    elif res_scale == 1.0:
        want_sum = x + branch
    else:
        want_sum = x + res_scale * branch
    want_ln = layer_norm(params, want_sum)
    before = aln.LAUNCHES
    for fn in (aln.add_layer_norm_plain, aln.add_layer_norm):
        got_sum, got_ln = fn(x, branch, params, res_scale)
        assert got_sum.dtype == got_ln.dtype == dtype
        assert torch.equal(got_sum, want_sum) and torch.equal(got_ln, want_ln)
        none_sum, ln_alone = fn(x, branch, params, res_scale, want_sum=False)
        assert none_sum is None and torch.equal(ln_alone, want_ln)
    assert aln.LAUNCHES == before


def test_plain_returns_x_itself_without_a_branch():
    x = _rand(3, 512, seed=3)
    got_sum, _ = aln.add_layer_norm_plain(x, None, _ln_params(512, torch.float32))
    assert got_sum is x


@pytest.mark.parametrize("d,dtype,param_dtype,takes", [
    (256, torch.bfloat16, torch.bfloat16, True),
    (1024, torch.bfloat16, torch.float32, True),
    (2048, torch.float32, torch.float32, True),
    (1024, torch.float32, torch.bfloat16, False),  # parameters of neither fp32 nor x's dtype
    (96, torch.bfloat16, torch.bfloat16, False),
    (128, torch.float32, torch.float32, False),
    (1000, torch.float32, torch.float32, False),
    (4096, torch.bfloat16, torch.bfloat16, False),
    (1024, torch.float16, torch.float16, False),
])
def test_kernel_takes(d, dtype, param_dtype, takes):
    """The gate the block reads: x bf16 or fp32, D a multiple of 256 up to
    2048, the parameters in fp32 or in x's dtype, both alike."""
    assert aln.kernel_takes(torch.zeros(2, d, dtype=dtype), _ln_params(d, param_dtype)) is takes
    if dtype == torch.bfloat16:  # a weight and a bias of two dtypes
        mixed = {"weight": torch.ones(d), "bias": torch.zeros(d, dtype=dtype)}
        assert not aln.kernel_takes(torch.zeros(2, d, dtype=dtype), mixed)


# -- the block -----------------------------------------------------------------------------


def _block(d, heads, dtype, seed=0):
    """One Conformer block's parameters at width d (FFN 2d, kernel 7), the
    LayerNorms and batch-norm not the identity, in ``dtype``."""
    from sonar_tpu_torch.assets.convert import init_speech_encoder_params
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.nn.transformer import layer_slices

    base = sonar_speech_encoder_archs.get("toy")
    ccfg = conformer.ConformerConfig(model_dim=d, num_layers=1, num_heads=heads,
                                     ffn_inner_dim=2 * d, depthwise_kernel_size=7)
    cfg = dataclasses.replace(
        base, conformer=ccfg,
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=d),
        model_dim=d, num_decoder_attn_heads=heads, ffn_inner_dim=2 * d)
    layers = init_speech_encoder_params(cfg, seed=seed)["encoder"]["layers"]
    rng = np.random.default_rng(seed + 7)
    for name in conformer._LAYER_NORMS:
        layers[name] = {"weight": rng.uniform(0.5, 1.5, (1, d)).astype(np.float32),
                        "bias": (rng.standard_normal((1, d)) * 0.1).astype(np.float32)}
    layers["conv"]["batch_norm"]["running_var"] = rng.uniform(0.5, 1.5, (1, d)).astype(np.float32)

    def to_torch(node):
        if isinstance(node, dict):
            return {k: to_torch(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node)).to(dtype)

    return layer_slices(to_torch(layers))[0], ccfg


def _eager_block(params, x, attn_bias, pad_mask, cfg):
    """The block's expression as the JAX package writes it."""
    x = x + 0.5 * conformer._half_ffn(params["ffn1"], layer_norm(params["ffn1_layer_norm"], x))
    x = x + conformer.rel_pos_attention(
        params["self_attn"], layer_norm(params["self_attn_layer_norm"], x), attn_bias, cfg)
    x = x + conformer.conv_module(params["conv"], layer_norm(params["conv_layer_norm"], x),
                                  pad_mask)
    x = x + 0.5 * conformer._half_ffn(params["ffn2"], layer_norm(params["ffn2_layer_norm"], x))
    return layer_norm(params["layer_norm"], x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,heads,s", [(128, 2, 40), (256, 2, 130)])
def test_conformer_block_on_cpu_is_the_eager_expression(dtype, d, heads, s):
    """D 128 (below the kernel's widths) and D 256 (a width it takes, with
    the rel-pos kernel's plain version at S 130): on CPU the block takes
    the eager path and returns the expression's bits, outside and inside
    the kernel scope, and launches nothing."""
    from sonar_tpu_torch.ops import masks

    params, cfg = _block(d, heads, dtype)
    x = _rand(2, s, d, dtype=dtype, seed=5)
    lens = torch.tensor([s, s - 13])
    mask = masks.length_mask(lens, s)
    bias = masks.additive_bias(mask)[:, None, None, :]
    assert not conformer._use_add_ln_kernel(params, x)
    before = aln.LAUNCHES
    with torch.inference_mode():
        want = _eager_block(params, x, bias, mask, cfg)
        got = conformer.conformer_block(params, x, bias, mask, cfg)
        with no_cuda_kernels():  # which also takes the rel-pos plain path
            scoped = conformer.conformer_block(params, x, bias, mask, cfg)
            want_scoped = _eager_block(params, x, bias, mask, cfg)
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(scoped, want_scoped)
    assert aln.LAUNCHES == before


def test_conformer_block_gradients_are_the_eager_expressions():
    """Under autograd (training) the block is the eager expression: the
    same gradients of its LayerNorms' parameters, bit for bit."""
    params, cfg = _block(128, 2, torch.float32, seed=1)
    x = _rand(2, 24, 128, seed=6)
    grads = []
    for fn in (conformer.conformer_block, _eager_block):
        leaves = {k: v for k, v in params.items() if k.endswith("layer_norm")}
        for p in leaves.values():
            for t in p.values():
                t.grad = None
                t.requires_grad_(True)
        fn(params, x, None, None, cfg).square().sum().backward()
        grads.append([t.grad.clone() for p in leaves.values() for t in p.values()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
