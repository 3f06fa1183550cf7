"""The port's text encoder and its modules against ``sonar_tpu`` on the same
numpy weights and inputs, on CPU.

Tolerances: fp32 modules atol 2e-5; fp32 whole-encoder embeddings atol 2e-4;
bf16 cosine >= 0.9999 per row; int8 cosine >= 0.999 per row (rows of
length >= 1 only).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.assets import checkpoint as ckpt  # noqa: E402
from sonar_tpu.inference_pipelines.text import JitTextEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_encoder_archs as jax_archs  # noqa: E402
from sonar_tpu.data.collate import SequenceBatch  # noqa: E402
from sonar_tpu.nn import core as jcore  # noqa: E402
from sonar_tpu.nn import pooling as jpool  # noqa: E402
from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.nn.frontend import EmbeddingFrontend as JaxFrontend  # noqa: E402
from sonar_tpu.ops import masks as jmasks  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    init_text_encoder_params,
    load_text_encoder_checkpoint,
    text_encoder_from_numpy,
    text_encoder_params_from_state,
)
from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.nn import core, pooling, transformer  # noqa: E402
from sonar_tpu_torch.nn.frontend import EmbeddingFrontend  # noqa: E402
from sonar_tpu_torch.ops import masks  # noqa: E402
from sonar_tpu_torch.ops.precision import matmul_precision_for  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _row_cos(a, b):
    a, b = _np(a), _np(b)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _jax_params(cfg, seed=0):
    params = JaxEncoder(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(rng, b, s, vocab, lens):
    seqs = rng.integers(4, vocab, size=(b, s)).astype(np.int32)
    for i, n in enumerate(lens):
        seqs[i, n:] = 1
    return seqs, np.asarray(lens, np.int32)


def _wide_cfg(arch_module, **kw):
    """2 layers at D = 128 (two heads of 64): wide enough for every kernel gate."""
    base = arch_module.get("toy")
    return dataclasses.replace(base, model_dim=128, num_encoder_attn_heads=2,
                               ffn_inner_dim=512, **kw)


# -- modules -------------------------------------------------------------------


def test_masks_and_bias_match():
    lens = np.asarray([3, 0, 5], np.int32)
    got = masks.additive_bias(masks.length_mask(torch.from_numpy(lens), 5))
    want = jmasks.additive_bias(jmasks.length_mask(jnp.asarray(lens), 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min().item() == float(np.finfo(np.float32).min)  # not -inf


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_linear_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 7, 64)).astype(np.float32)
    ln = {"weight": rng.normal(size=(64,)).astype(np.float32),
          "bias": rng.normal(size=(64,)).astype(np.float32)}
    lin = {"kernel": (rng.normal(size=(64, 48)) * 0.1).astype(np.float32),
           "bias": rng.normal(size=(48,)).astype(np.float32)}
    tdt, jdt = DTYPES[dtype]
    t = lambda tree: {k: torch.from_numpy(v) for k, v in tree.items()}
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    for got, want in (
        (core.layer_norm(t(ln), xt), jcore.layer_norm(j(ln), xj)),
        (core.linear(t(lin), xt), jcore.linear(j(lin), xj)),
    ):
        assert got.dtype == tdt
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        else:
            assert _row_cos(got, want).min() >= 0.9999


def test_frontend_position_table_matches():
    rng = np.random.default_rng(1)
    embed = {"weight": (rng.normal(size=(50, 32)) * 0.2).astype(np.float32)}
    ids = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    got = EmbeddingFrontend(32, 20, legacy_pad_idx=1)(
        {"embed": {"weight": torch.from_numpy(embed["weight"])}}, torch.from_numpy(ids))
    want = JaxFrontend(32, 20, legacy_pad_idx=1, dropout_p=0.0)(
        {"embed": {"weight": jnp.asarray(embed["weight"])}}, jnp.asarray(ids))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("mode", ["mean", "max", "last"])
def test_pooling_matches(mode):
    rng = np.random.default_rng(2)
    seqs = rng.normal(size=(3, 6, 8)).astype(np.float32)
    lens = np.asarray([6, 2, 1], np.int32)
    got = pooling.static_pool(torch.from_numpy(seqs), torch.from_numpy(lens),
                              pooling.Pooling(mode))
    want = jpool.static_pool(jnp.asarray(seqs), jnp.asarray(lens), jpool.Pooling(mode))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


def test_fuse_qkv_layout_matches():
    params = _jax_params(jax_archs.get("toy"))
    got = transformer.fuse_qkv(text_encoder_from_numpy(
        params, sonar_text_encoder_archs.get("toy")).params.tree())
    want = jtr.fuse_qkv(params)
    for key in ("kernel", "bias"):
        np.testing.assert_array_equal(
            got["encoder"]["layers"]["self_attn"]["qkv_proj"][key].numpy(),
            np.asarray(want["encoder"]["layers"]["self_attn"]["qkv_proj"][key]))


def test_fp32_mode_disables_tf32():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    with matmul_precision_for(torch.float32):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# -- whole encoder -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_toy_encoder_matches_jax(dtype):
    cfg = jax_archs.get("toy")
    params = _jax_params(cfg)
    rng = np.random.default_rng(3)
    seqs, lens = _batch(rng, 4, 20, 1000, [20, 13, 5, 1])
    tdt, jdt = DTYPES[dtype]
    model = text_encoder_from_numpy(params, sonar_text_encoder_archs.get("toy"), tdt)
    with torch.inference_mode():
        got = model(torch.from_numpy(seqs), torch.from_numpy(lens))
    want = JaxEncoder(cfg, dtype=jdt).apply(params, jnp.asarray(seqs), jnp.asarray(lens))
    assert got.sentence_embeddings.dtype == tdt
    assert got.encoded_seqs.shape == (4, 20, 32)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got.sentence_embeddings),
                                   _np(want.sentence_embeddings), atol=2e-4)
    else:
        assert _row_cos(got.sentence_embeddings, want.sentence_embeddings).min() >= 0.9999


@pytest.mark.parametrize("fuse", [False, True])
def test_toy_encoder_int8_matches_jax(fuse):
    cfg = jax_archs.get("toy")
    params = _jax_params(cfg, seed=1)
    rng = np.random.default_rng(4)
    seqs, lens = _batch(rng, 4, 16, 1000, [16, 9, 3, 0])
    batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=4)
    enc = TorchTextEncoder(text_encoder_from_numpy(params, sonar_text_encoder_archs.get("toy")),
                           fuse_qkv=fuse, quantize=True, device="cpu")
    got = enc.encode_batch(batch)
    want = JitTextEncoder(JaxEncoder(cfg), params, fuse_qkv=fuse, quantize=True).encode_batch(batch)
    assert _row_cos(got[:3], want[:3]).min() >= 0.999


@pytest.mark.parametrize("mode", ["int8_blocks", "int8_blocks_long", "int8_flash", "bf16_flash",
                                  "fp32_short"])
def test_wide_encoder_through_every_gate(mode):
    """D = 128 with enough tokens: the block kernels (fused q/k/v, S >= 8,
    >= 2048 tokens; at S 256 the attention step in two passes), the fused
    FFN + flash attention (q/k/v unfused, S >= 256), and the short
    attention, each against the JAX package's CPU path."""
    cfg, tcfg = _wide_cfg(jax_archs), _wide_cfg(sonar_text_encoder_archs)
    params = _jax_params(cfg, seed=2)
    rng = np.random.default_rng(5)
    if mode == "int8_blocks":
        seqs, lens = _batch(rng, 64, 32, 1000, [32, 17, 0] + [8 + i % 24 for i in range(61)])
    elif mode == "fp32_short":
        seqs, lens = _batch(rng, 3, 24, 1000, [24, 10, 2])
    else:
        seqs, lens = _batch(rng, 8, 256, 1000, [256, 200, 0] + [40 * (i + 1) for i in range(5)])
    batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=len(lens))
    tdt, jdt = DTYPES["bfloat16" if mode == "bf16_flash" else "float32"]
    quantize = mode.startswith("int8")
    enc = TorchTextEncoder(text_encoder_from_numpy(params, tcfg, tdt), quantize=quantize,
                           fuse_qkv=mode != "int8_flash", device="cpu")
    got = enc.encode_batch(batch)
    want = np.asarray(JitTextEncoder(JaxEncoder(cfg, dtype=jdt), params,
                                     quantize=quantize).encode_batch(batch), np.float32)
    valid = lens > 0
    if mode == "fp32_short":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        assert _row_cos(got[valid], want[valid]).min() >= (0.999 if quantize else 0.9999)


def test_kernel_gates_route_like_jax():
    from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, short_attn

    calls = []
    originals = {}
    for mod, name in ((attn_block, "fused_attn_block_plain"), (ffn, "fused_ffn_plain"),
                      (flash, "flash_attention_plain"), (short_attn, "short_qkv_attention_plain")):
        originals[(mod, name)] = fn = getattr(mod, name)
        setattr(mod, name, (lambda f, n: lambda *a, **k: (calls.append(n), f(*a, **k))[1])(fn, name))
    try:
        tcfg = _wide_cfg(sonar_text_encoder_archs)
        params = init_text_encoder_params(tcfg, seed=0)
        enc = TorchTextEncoder(text_encoder_from_numpy(params, tcfg), quantize=True,
                               device="cpu")
        for b, s in ((64, 32), (2, 256), (2, 16)):
            calls.clear()
            enc.encode_batch(SequenceBatch(seqs=np.full((b, s), 5, np.int32),
                                           seq_lens=np.full((b,), s, np.int32), true_batch=b))
            if (b, s) == (64, 32):
                assert set(calls) == {"fused_attn_block_plain", "fused_ffn_plain"}
            elif s == 256:
                assert set(calls) == {"flash_attention_plain"}  # 512 tokens < 2048: no fused FFN
            else:
                assert set(calls) == {"short_qkv_attention_plain"}
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)


def _layer(rows, s, quantize=True, seed=0):
    """One D 128 (two heads of 64), FFN 256 layer with fused q/k/v, int8 or
    float, and x [rows, s, 128]."""
    from sonar_tpu_torch.ops.quantization import quantize_params_int8

    gen = torch.Generator().manual_seed(seed)

    def lin(i, o):
        return {"kernel": torch.randn(i, o, generator=gen) * i ** -0.5,
                "bias": torch.randn(o, generator=gen) * 0.1}

    def ln(d):
        return {"weight": 1 + 0.1 * torch.randn(d, generator=gen),
                "bias": 0.1 * torch.randn(d, generator=gen)}

    layer = transformer.fuse_qkv({
        "self_attn": {n: lin(128, 128) for n in ("q_proj", "k_proj", "v_proj", "output_proj")},
        "self_attn_layer_norm": ln(128),
        "ffn": {"inner_proj": lin(128, 256), "output_proj": lin(256, 128)},
        "ffn_layer_norm": ln(128)}, keep_split=False)
    return (quantize_params_int8(layer) if quantize else layer,
            torch.randn(rows, s, 128, generator=gen))


def _key_bias_of(lens, s):
    return masks.additive_bias(masks.length_mask(torch.tensor(lens), s))[:, None, None, :]


_ROUTES = (("attn_block", "fused_attn_block"), ("ffn", "fused_int8_ffn_ln"),
           ("ffn", "fused_int8_ffn"), ("flash", "flash_attention"),
           ("short_attn", "short_qkv_attention"))


def _routes(monkeypatch, fn):
    """(fn(), the set of kernel wrappers and ``int8_linear`` it called)."""
    import importlib

    from sonar_tpu_torch.ops import quantization

    called = set()
    targets = [(importlib.import_module(f"sonar_tpu_torch.ops.cuda.{m}"), n) for m, n in _ROUTES]
    for mod, name in targets + [(quantization, "int8_linear")]:
        wrapped = getattr(mod, name)
        monkeypatch.setattr(mod, name, (lambda f, n: lambda *a, **k: (called.add(n),
                                                                      f(*a, **k))[1])(wrapped, name))
    out = fn()
    monkeypatch.undo()
    return out, called


@pytest.mark.parametrize("s", [192, 384, 512])
def test_int8_layer_takes_the_block_kernels_past_s_128(s, monkeypatch):
    """An int8 pre-LN layer at S 192-512 with key padding and >= 2048 tokens
    reaches #2 and #3 with LN and no eager int8 projection, and agrees with
    the eager int8 path (its kernels off) as the S 128 block cases do:
    cosine >= 0.999 per position of a row of length >= 1, and within 2e-2
    of the output's largest magnitude."""
    from sonar_tpu_torch.ops.gates import no_cuda_kernels

    rows = -(-2048 // s)
    params, x = _layer(rows, s)
    lens = [s, 0] + [s // 2 + 29 * i % (s // 2) for i in range(rows - 2)]
    bias = _key_bias_of(lens, s)
    layer = lambda: transformer.encoder_layer(params, x, bias, 2, "relu")  # noqa: E731
    with torch.inference_mode():
        got, calls = _routes(monkeypatch, layer)
        assert calls == {"fused_attn_block", "fused_int8_ffn_ln"}
        with no_cuda_kernels():
            want, calls = _routes(monkeypatch, layer)
        assert calls == {"int8_linear"}
    valid = masks.length_mask(torch.tensor(lens), s)
    g, w = got[valid].double(), want[valid].double()
    assert torch.nn.functional.cosine_similarity(g, w, dim=-1).min().item() >= 0.999
    assert (g - w).abs().max().item() <= 2e-2 * w.abs().max().item()


@pytest.mark.parametrize("case,s,rows,want", [
    ("int8", 128, 16, {"fused_attn_block", "fused_int8_ffn_ln"}),
    ("int8_few_tokens", 64, 4, {"short_qkv_attention", "int8_linear"}),
    ("bf16", 512, 4, {"flash_attention"}),
    ("packed_int8", 512, 4, {"flash_attention", "int8_linear", "fused_int8_ffn"}),
    ("autograd_int8", 384, 6, {"int8_linear"}),
])
def test_layer_inputs_outside_the_long_block_path_keep_theirs(case, s, rows, want, monkeypatch):
    """What the block gate's S bound did not decide routes as before: int8 at
    S 128 to the block kernels, int8 with fewer than 2048 tokens to the
    short attention and eager projections, bf16 to flash, packed rows (a
    full bias, not a key bias) to flash and the standalone int8 FFN, and
    anything autograd records to no kernel."""
    params, x = _layer(rows, s, quantize=case != "bf16")
    if case == "bf16":
        x = x.bfloat16()
    if case == "packed_int8":  # three segments a row, the last row half padding
        seg = torch.arange(s).repeat(rows, 1) * 3 // s + 1
        seg[-1, s // 2:] = 0
        real = seg > 0
        bias = masks.additive_bias((seg[:, :, None] == seg[:, None, :])
                                   & real[:, :, None] & real[:, None, :])[:, None]
    else:
        bias = _key_bias_of([s] + [s // 2] * (rows - 1), s)
    layer = lambda: transformer.encoder_layer(params, x, bias, 2, "relu")  # noqa: E731
    if case == "autograd_int8":
        for leaf in core.tree_leaves(params):
            if leaf.is_floating_point():
                leaf.requires_grad_(True)
        out, calls = _routes(monkeypatch, layer)
        assert out.requires_grad
    else:
        with torch.inference_mode():
            out, calls = _routes(monkeypatch, layer)
    assert torch.isfinite(out.float()).all()
    assert calls == want


# -- weights -------------------------------------------------------------------


def test_weight_bridge_round_trip():
    cfg = sonar_text_encoder_archs.get("toy")
    params = init_text_encoder_params(cfg, seed=7)
    model = text_encoder_from_numpy(params, cfg)
    back = model.params.tree()
    flat_in = ckpt.flatten_params(params)
    flat_out = ckpt.flatten_params(back)  # np.asarray of each tensor
    assert flat_in.keys() == flat_out.keys()
    for k in flat_in:
        np.testing.assert_array_equal(flat_in[k], flat_out[k])
    # Same tree structure and shapes as the JAX init.
    jax_flat = ckpt.flatten_params(_jax_params(jax_archs.get("toy")))
    assert {k: v.shape for k, v in jax_flat.items()} == {k: v.shape for k, v in flat_in.items()}
    assert np.all(params["encoder_frontend"]["embed"]["weight"][1] == 0)  # pad row
    assert set(model.state_dict()) == {k.replace("/", ".").join(["params.", ""]) for k in flat_in}


def _fairseq2_state(cfg, params):
    """The pytree written back as a fairseq2 state dict (torch [out, in])."""
    state = {"encoder_frontend.embed.weight": params["encoder_frontend"]["embed"]["weight"],
             "layer_norm.weight": params["layer_norm"]["weight"],
             "layer_norm.bias": params["layer_norm"]["bias"]}
    layers = params["encoder"]["layers"]
    for i in range(cfg.num_encoder_layers):
        p = f"encoder.layers.{i}"
        for blk, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "output_proj")),
                           ("ffn", ("inner_proj", "output_proj"))):
            for n in names:
                state[f"{p}.{blk}.{n}.weight"] = layers[blk][n]["kernel"][i].T
                state[f"{p}.{blk}.{n}.bias"] = layers[blk][n]["bias"][i]
        for ln in ("self_attn_layer_norm", "ffn_layer_norm"):
            state[f"{p}.{ln}.weight"] = layers[ln]["weight"][i]
            state[f"{p}.{ln}.bias"] = layers[ln]["bias"][i]
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in state.items()}


def test_fairseq2_checkpoint_loads_in_both_packages(tmp_path):
    cfg, tcfg = jax_archs.get("toy"), sonar_text_encoder_archs.get("toy")
    params = _jax_params(cfg, seed=3)
    path = tmp_path / "encoder.pt"
    torch.save({"model": _fairseq2_state(cfg, params)}, path)

    flat = ckpt.load_torch_state_dict(path)
    jax_tree = ckpt.flatten_params(ckpt.text_encoder_params(flat))
    port_tree = ckpt.flatten_params(text_encoder_params_from_state(flat))
    assert jax_tree.keys() == port_tree.keys()
    for k in jax_tree:
        np.testing.assert_array_equal(jax_tree[k], port_tree[k])

    rng = np.random.default_rng(6)
    seqs, lens = _batch(rng, 3, 12, 1000, [12, 7, 2])
    model = load_text_encoder_checkpoint(path, tcfg)
    with torch.inference_mode():
        got = model(torch.from_numpy(seqs), torch.from_numpy(lens)).sentence_embeddings
    want = JaxEncoder(cfg).apply(ckpt.text_encoder_params(flat), jnp.asarray(seqs),
                                 jnp.asarray(lens)).sentence_embeddings
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)


def _pooler_state(cfg, pooler):
    """An ATTENTION pooler's pytree as fairseq2 ``pooler.*`` state entries."""
    state = {"pooler.decoder_frontend.embed.weight": pooler["decoder_frontend"]["embed"]["weight"],
             "pooler.projection_out.weight": pooler["projection_out"]["kernel"].T,
             "pooler.projection_out.bias": pooler["projection_out"]["bias"]}
    if "layer_norm" in pooler["decoder"]:
        for k in ("weight", "bias"):
            state[f"pooler.decoder.layer_norm.{k}"] = pooler["decoder"]["layer_norm"][k]
    layers = pooler["decoder"]["layers"]
    for i in range(cfg.num_decoder_layers):
        p = f"pooler.decoder.layers.{i}"
        for blk, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "output_proj")),
                           ("encoder_decoder_attn", ("q_proj", "k_proj", "v_proj", "output_proj")),
                           ("ffn", ("inner_proj", "output_proj"))):
            for n in names:
                state[f"{p}.{blk}.{n}.weight"] = layers[blk][n]["kernel"][i].T
                state[f"{p}.{blk}.{n}.bias"] = layers[blk][n]["bias"][i]
        for ln in ("self_attn_layer_norm", "encoder_decoder_attn_layer_norm", "ffn_layer_norm"):
            for k in ("weight", "bias"):
                state[f"{p}.{ln}.{k}"] = layers[ln][k][i]
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in state.items()}


@pytest.mark.parametrize("normalize_before", [False, True])
def test_toy_attention_pooler_matches_jax(tmp_path, normalize_before):
    """The ATTENTION pooler (a post- or pre-LN decoder attending from one BOS
    token, then a biased projection), with weights from the JAX init and
    through the fairseq2 checkpoint bridge; fp32 atol 2e-4 as the encoder."""
    cfg = dataclasses.replace(jax_archs.get("toy"), pooling="attention",
                              normalize_before=normalize_before)
    tcfg = dataclasses.replace(sonar_text_encoder_archs.get("toy"), pooling="attention",
                               normalize_before=normalize_before)
    params = _jax_params(cfg, seed=5)
    got_shapes = {k: v.shape for k, v in ckpt.flatten_params(
        init_text_encoder_params(tcfg, seed=0)).items()}
    assert got_shapes == {k: v.shape for k, v in ckpt.flatten_params(params).items()}

    rng = np.random.default_rng(8)
    seqs, lens = _batch(rng, 3, 12, 1000, [12, 5, 1])
    want = JaxEncoder(cfg).apply(params, jnp.asarray(seqs), jnp.asarray(lens)).sentence_embeddings
    with torch.inference_mode():
        got = text_encoder_from_numpy(params, tcfg)(
            torch.from_numpy(seqs), torch.from_numpy(lens)).sentence_embeddings
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)

    state = {**_fairseq2_state(cfg, params), **_pooler_state(cfg, params["pooler"])}
    if normalize_before:
        for k in ("weight", "bias"):
            state[f"encoder.layer_norm.{k}"] = torch.tensor(params["encoder"]["layer_norm"][k])
    path = tmp_path / "encoder.pt"
    torch.save({"model": state}, path)
    flat = ckpt.load_torch_state_dict(path)
    jax_tree = ckpt.flatten_params(ckpt.text_encoder_params(flat))
    port_tree = ckpt.flatten_params(text_encoder_params_from_state(flat))
    assert jax_tree.keys() == port_tree.keys()
    for k in jax_tree:
        np.testing.assert_array_equal(jax_tree[k], port_tree[k])
    with torch.inference_mode():
        loaded = load_text_encoder_checkpoint(path, tcfg)(
            torch.from_numpy(seqs), torch.from_numpy(lens)).sentence_embeddings
    np.testing.assert_allclose(_np(loaded), _np(want), atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hub_loads_a_card_like_the_jax_hub(tmp_path, dtype):
    from sonar_tpu.assets import hub as jax_hub
    from sonar_tpu.assets.store import ModelCard, default_store
    from sonar_tpu_torch.assets import hub
    from sonar_tpu_torch.assets import store as port_store

    cfg = jax_archs.get("toy")
    params = _jax_params(cfg, seed=4)
    path = tmp_path / "encoder.pt"
    torch.save({"model": _fairseq2_state(cfg, params)}, path)
    name = f"torch_port_test_card_{dtype}"
    store, pstore = default_store(), port_store.default_store()
    store.register_model(ModelCard(name=name, family="sonar_text_encoder", arch="toy",
                                   checkpoint=str(path)))
    pstore.register_model(port_store.ModelCard(name=name, family="sonar_text_encoder",
                                               arch="toy", checkpoint=str(path)))
    tdt, jdt = DTYPES[dtype]
    try:
        port = hub.load_text_encoder(name, dtype=tdt, device="cpu")
        ref = jax_hub.load_text_encoder(name, dtype=jdt)
    finally:
        del store.models[name], pstore.models[name]
    rng = np.random.default_rng(7)
    seqs, lens = _batch(rng, 3, 12, 1000, [12, 7, 2])
    batch = SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=3)
    got, want = port.encode_batch(batch), np.asarray(ref.encode_batch(batch), np.float32)
    assert port.dtype == tdt and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4)
    else:
        assert _row_cos(got, want).min() >= 0.9999


def test_toy_encoder_matches_committed_self_golden():
    """The committed fp32 golden of the JAX toy encoder
    (``tests/data/self_goldens.npz``, seed PRNGKey(0)) from the port."""
    from pathlib import Path

    golden = np.load(Path(__file__).parent.parent / "data" / "self_goldens.npz")
    params = _jax_params(jax_archs.get("toy"), seed=0)
    model = text_encoder_from_numpy(params, sonar_text_encoder_archs.get("toy"))
    with torch.inference_mode():
        got = model(torch.from_numpy(golden["text_seqs"]),
                    torch.from_numpy(golden["text_lens"])).sentence_embeddings
    np.testing.assert_allclose(got.numpy(), golden["text_emb"], atol=1e-4, rtol=1e-4)
