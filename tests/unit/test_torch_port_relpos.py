"""The port's rel-pos attention against ``sonar_tpu`` on CPU: both kernels'
plain versions against the Pallas kernels in interpret mode, and the
Conformer modules on both sides of the kernel gate.

Tolerances:
- fp32: atol 2e-5 (outputs of scale ~1; the products are fp32 in both, in
  other summation orders);
- bf16: every row's cosine >= 0.9999 and max-abs <= 2e-2 of the output's
  scale for the kernels (a bf16 rounding of w, P or the output may flip),
  cosine >= 0.999 for whole modules (several bf16 roundings in a row).
Rows whose every key is masked are held to finiteness only where S is not
a multiple of 128: the JAX wrapper pads S with masked zero keys, so its
uniform average runs over the padded length, the port's over S.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.nn import conformer as jconf  # noqa: E402
from sonar_tpu.ops import attention as jattn  # noqa: E402
from sonar_tpu.ops import masks as jmasks  # noqa: E402
from sonar_tpu.ops.pallas import relpos_flash as jrp  # noqa: E402
from sonar_tpu_torch.nn import conformer  # noqa: E402
from sonar_tpu_torch.ops import masks  # noqa: E402
from sonar_tpu_torch.ops.cuda import relpos_flash  # noqa: E402

F32_MIN = np.finfo(np.float32).min
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
CFG = jconf.ConformerConfig(model_dim=128, num_layers=1, num_heads=2, ffn_inner_dim=256,
                            depthwise_kernel_size=7)
PORT_CFG = conformer.ConformerConfig(model_dim=128, num_layers=1, num_heads=2,
                                     ffn_inner_dim=256, depthwise_kernel_size=7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _row_cos(a, b):
    a, b = _np(a).reshape(-1, a.shape[-1]), _np(b).reshape(-1, b.shape[-1])
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _assert_close(got, want, dtype, kernel=True):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
        return
    assert _row_cos(got, want).min() >= (0.9999 if kernel else 0.999)
    if kernel:
        scale = np.abs(_np(want)).max()
        assert np.abs(_np(got) - _np(want)).max() <= 2e-2 * scale


def _lens_bias(lens, s):
    return np.where(np.arange(s)[None, :] < np.asarray(lens)[:, None], 0.0, F32_MIN).astype(
        np.float32)


def _both(a, dtype):
    t, j = DT[dtype]
    return torch.from_numpy(a).to(t), jnp.asarray(a, j)


@contextlib.contextmanager
def _jax_kernel_forced():
    """The JAX Conformer on its Pallas kernel in interpret mode (on CPU it
    takes the XLA lowering otherwise)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    pl.pallas_call = patched
    jattn.set_attention_impl("pallas")
    try:
        yield
    finally:
        pl.pallas_call = orig
        jattn.set_attention_impl("auto")


# -- the two kernels' plain versions -----------------------------------------------


KERNEL_CASES = [(128, 64, "float32"), (130, 64, "float32"), (257, 64, "float32"),
                (128, 64, "bfloat16"), (130, 64, "bfloat16"), (257, 64, "bfloat16"),
                (130, 128, "bfloat16")]


def _kernel_inputs(s, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    b, h = 3, 2
    d = h * dh
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32) for _ in range(3))
    wr = (rng.standard_normal((h, d, dh)) * d ** -0.5).astype(np.float32)
    u, vb = ((rng.standard_normal((h, dh)) * 0.1).astype(np.float32) for _ in range(2))
    si, ci, basis = conformer.rel_pos_sin_cos_basis(s, d)
    lens = [s, s // 2 + 3, 0]  # ragged, with a padding row of length 0
    return dict(q=q, k=k, v=v, wr=wr, si=si, ci=ci, basis=basis, u=u, vb=vb,
                key_bias=_lens_bias(lens, s)), lens


def _check_rows(got, want, lens, s, dtype):
    real = [i for i, n in enumerate(lens) if n > 0]
    _assert_close(got[real], want[real], dtype)
    assert np.isfinite(_np(got)).all()
    if s % 128 == 0:
        _assert_close(got, want, dtype)


@pytest.mark.parametrize("s,dh,dtype", KERNEL_CASES)
def test_v2_plain_matches_pallas_kernel(s, dh, dtype):
    inp, lens = _kernel_inputs(s, dh, dtype)
    port = {k: _both(v, dtype if k != "key_bias" else "float32")[0] for k, v in inp.items()}
    jx = {k: _both(v, dtype if k != "key_bias" else "float32")[1] for k, v in inp.items()}
    names = ("q", "k", "v", "wr", "si", "ci", "basis", "u", "vb", "key_bias")
    got = relpos_flash.relpos_flash_attention_v2(*(port[n] for n in names))
    want = jrp.relpos_flash_attention_v2(*(jx[n] for n in names), interpret=True)
    assert got.dtype == DT[dtype][0] and got.shape == tuple(inp["q"].shape)
    _check_rows(got, np.asarray(want, np.float32), lens, s, dtype)


@pytest.mark.parametrize("s,dh", [(130, 64), (257, 128)])
def test_bd_shift_plain_matches_trig_form(s, dh):
    """The rel-shift form of the card's bf16 kernel (the distance table from
    si / ci by reflection, then (q + v) . P[i - j]) against the trig form in
    fp32, to 2e-5 of bd's scale: the sign of i - j, the de-interleaved
    columns and the reflection."""
    inp, _ = _kernel_inputs(s, dh, "float32", seed=3)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    assert t["u"].abs().min() > 0 and t["vb"].abs().min() > 0
    got = relpos_flash.relpos_bd_shift_plain(t["q"], t["wr"], t["si"], t["ci"], t["vb"])
    want = relpos_flash.relpos_bd_plain(t["q"], t["wr"], t["si"], t["ci"], t["basis"], t["vb"])
    assert got.shape == want.shape == (3, 2, s, s)
    scale = want.abs().max().item()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * scale, rtol=0)


# v1's cases: those of v2 (their ids as before), S 499 (the speech batch's
# length: not a multiple of the bf16 kernel's 64-key tile) and bd scaled by
# 30, so that a few keys hold each row and most exponentials are tiny.
V1_CASES = [pytest.param(s, dh, dtype, 1.0, id=f"{s}-{dh}-{dtype}")
            for s, dh, dtype in KERNEL_CASES] + [
    pytest.param(499, 64, "bfloat16", 1.0, id="499-64-bfloat16"),
    pytest.param(499, 64, "float32", 1.0, id="499-64-float32"),
    pytest.param(257, 64, "bfloat16", 30.0, id="257-64-bfloat16-bd-x30"),
    pytest.param(130, 128, "float32", 30.0, id="130-128-float32-bd-x30"),
]


@pytest.mark.parametrize("s,dh,dtype,bd_scale", V1_CASES)
def test_v1_plain_matches_pallas_kernel(s, dh, dtype, bd_scale):
    inp, lens = _kernel_inputs(s, dh, dtype, seed=1)
    rng = np.random.default_rng(2)
    bd = rng.standard_normal((3, 2, s, s)).astype(np.float32) * np.float32(bd_scale)
    (q, jq), (k, jk), (v, jv), (bd_t, jbd), (u, ju) = (
        _both(x, dtype) for x in (inp["q"], inp["k"], inp["v"], bd, inp["u"]))
    kb, jkb = _both(inp["key_bias"], "float32")
    got = relpos_flash.relpos_flash_attention(q, k, v, bd_t, u, kb)
    want = jrp.relpos_flash_attention(jq, jk, jv, jbd, ju, jkb, interpret=True)
    _check_rows(got, np.asarray(want, np.float32), lens, s, dtype)


def test_wrappers_run_the_plain_version_on_cpu_tensors():
    inp, _ = _kernel_inputs(128, 64, "float32")
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    before = (relpos_flash.LAUNCHES, relpos_flash.V1_LAUNCHES)
    got = relpos_flash.relpos_flash_attention_v2(
        t["q"], t["k"], t["v"], t["wr"], t["si"], t["ci"], t["basis"], t["u"], t["vb"],
        t["key_bias"])
    want = relpos_flash.relpos_flash_attention_v2_plain(
        t["q"], t["k"], t["v"], t["wr"], t["si"], t["ci"], t["basis"], t["u"], t["vb"],
        t["key_bias"])
    assert torch.equal(got, want)
    assert (relpos_flash.LAUNCHES, relpos_flash.V1_LAUNCHES) == before


# -- the Conformer modules --------------------------------------------------------------


def _jax_params(cfg, init, seed=0):
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed), cfg))


def _port_tree(params, dtype):
    t = DT[dtype][0]
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)).to(t), params)


def _jax_tree(params, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, DT[dtype][1]), params)


def _x_and_bias(b, s, lens, seed=1):
    x = np.random.default_rng(seed).standard_normal((b, s, 128)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    pbias = masks.additive_bias(masks.length_mask(torch.from_numpy(lens), s))[:, None, None, :]
    jbias = jmasks.additive_bias(jmasks.length_mask(jnp.asarray(lens), s))[:, None, None, :]
    pmask = masks.length_mask(torch.from_numpy(lens), s)
    jmask = jmasks.length_mask(jnp.asarray(lens), s)
    return x, (pbias, pmask), (jbias, jmask), lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [96, 130, 257])
def test_rel_pos_attention_matches_jax(s, dtype):
    """S 96 takes the plain path on both sides; S 130 and 257 the kernel
    (the port's v2 plain version, the JAX Pallas kernel in interpret mode)."""
    params = _jax_params(CFG, jconf.init_rel_pos_attention)
    x, (pbias, _), (jbias, _), lens = _x_and_bias(2, s, [s, s - 37])
    calls = conformer.PLAIN_CALLS
    got = conformer.rel_pos_attention(_port_tree(params, dtype), _both(x, dtype)[0], pbias,
                                      PORT_CFG)
    assert conformer.PLAIN_CALLS == calls + (s < 128)
    forced = _jax_kernel_forced() if s >= 128 else contextlib.nullcontext()
    with forced:
        want = jax.jit(jconf.rel_pos_attention, static_argnames="cfg")(
            _jax_tree(params, dtype), _both(x, dtype)[1], jbias, cfg=CFG)
    _assert_close(got, np.asarray(want, np.float32), dtype, kernel=False)


def test_kernel_path_reads_wr_heads(monkeypatch):
    """The kernel path hands the kernel r_proj laid out per head with its
    input columns de-interleaved (the JAX wrapper's Wr_h), made from the
    layer's r_proj at each call: after r_proj changes in place, the next
    call reads the new weights, and the tree holds no copy to go stale."""
    p = _port_tree(_jax_params(CFG, jconf.init_rel_pos_attention), "float32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 130, 128)).astype(
        np.float32))
    seen = []
    kernel = relpos_flash.relpos_flash_attention_v2
    monkeypatch.setattr(relpos_flash, "relpos_flash_attention_v2",
                        lambda q, k, v, wrh, *rest: seen.append(wrh) or kernel(q, k, v, wrh, *rest))
    for _ in range(2):
        conformer.rel_pos_attention(p, x, None, PORT_CFG)
        want = p["sdpa"]["r_proj"]["kernel"].reshape(128, 2, 64).permute(1, 0, 2)
        want = torch.cat([want[:, 0::2], want[:, 1::2]], dim=1)
        wrh = seen[-1]
        assert wrh.shape == (2, 128, 64) and wrh.is_contiguous()
        assert torch.equal(wrh, want)
        p["sdpa"]["r_proj"]["kernel"].mul_(-0.5)
    assert len(seen) == 2 and "wr_heads" not in p["sdpa"]


def test_kernel_gate_bounds():
    """The JAX gate on shapes: 128 <= S <= 2048, head dim 64 or 128, and a
    broadcastable [B, 1, 1, S] key mask."""
    gate = conformer._use_relpos_kernel
    assert gate(None, 512, 64) and gate(None, 2048, 64) and gate(None, 128, 128)
    assert not gate(None, 2049, 64)
    assert not gate(None, 3000, 64)  # a 60 s clip
    assert not gate(None, 127, 64)
    assert not gate(None, 512, 32)
    assert gate(torch.zeros(2, 1, 1, 512), 512, 64)
    assert not gate(torch.zeros(2, 4, 1, 512), 512, 64)
    assert not gate(torch.zeros(2, 1, 512, 512), 512, 64)
    x = jnp.zeros((1, 1, 1))
    jattn.set_attention_impl("pallas")
    try:
        for bias, s, hd in ((None, 2048, 64), (None, 2049, 64), (None, 127, 64),
                            (None, 512, 32), (jnp.zeros((2, 4, 1, 512)), 512, 64)):
            pbias = None if bias is None else torch.zeros(tuple(bias.shape))
            assert gate(pbias, s, hd) == jconf._use_relpos_kernel(x, bias, s, hd)
    finally:
        jattn.set_attention_impl("auto")


def test_rel_pos_plain_path_matches_brute_force():
    """The plain path's factorised bd equals z . r(i - j) from the table."""
    params = _jax_params(CFG, jconf.init_rel_pos_attention)
    p = _port_tree(params, "float32")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 9, 128)).astype(np.float32))
    q, k, v = conformer.rel_pos_qkv(p, x, 2)
    table = conformer.rel_pos_table(9, 128)                              # [17, D]
    r = (table @ p["sdpa"]["r_proj"]["kernel"]).reshape(17, 2, 64)       # projected
    idx = 8 - torch.arange(9)[:, None] + torch.arange(9)[None, :]        # row of i - j
    qv = q + p["sdpa"]["v_bias"][None, :, None, :]
    bd = torch.einsum("bhid,ijhd->bhij", qv, r[idx])
    ac = (q + p["sdpa"]["u_bias"][None, :, None, :]) @ k.transpose(-1, -2)
    probs = torch.softmax((ac + bd) / 8.0, dim=-1)
    want = (probs @ v).transpose(1, 2).reshape(1, 9, 128) @ p["output_proj"]["kernel"] \
        + p["output_proj"]["bias"]
    got = conformer.rel_pos_attention(p, x, None, PORT_CFG)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_module_matches_jax(dtype):
    params = _jax_params(CFG, jconf.init_conv_module)
    rng = np.random.default_rng(4)
    # Non-trivial batch-norm statistics.
    params["batch_norm"] = {k: rng.uniform(0.5, 1.5, 128).astype(np.float32) if k in (
        "weight", "running_var") else (rng.standard_normal(128) * 0.1).astype(np.float32)
        for k in ("weight", "bias", "running_mean", "running_var")}
    x, (_, pmask), (_, jmask), _ = _x_and_bias(3, 40, [40, 23, 0])
    with torch.inference_mode():
        got = conformer.conv_module(_port_tree(params, dtype), _both(x, dtype)[0], pmask)
    want = jax.jit(jconf.conv_module)(_jax_tree(params, dtype), _both(x, dtype)[1], jmask)
    real = np.asarray([0, 1])
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    else:
        assert _row_cos(got[real], np.asarray(want, np.float32)[real]).min() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [96, 130])
def test_conformer_block_matches_jax(s, dtype):
    params = _jax_params(CFG, jconf.init_conformer_block)
    x, (pbias, pmask), (jbias, jmask), lens = _x_and_bias(2, s, [s, s - 21])
    p = _port_tree(params, dtype)
    got = conformer.conformer_block(p, _both(x, dtype)[0], pbias, pmask, PORT_CFG)
    forced = _jax_kernel_forced() if s >= 128 else contextlib.nullcontext()
    with forced:
        want = jax.jit(jconf.conformer_block, static_argnames="cfg")(
            _jax_tree(params, dtype), _both(x, dtype)[1], jbias, jmask, cfg=CFG)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    else:
        rows = [got[i, :n] for i, n in enumerate(lens)]
        wants = [want[i, :n] for i, n in enumerate(lens)]
        assert min(_row_cos(g, w).min() for g, w in zip(rows, wants)) >= 0.999
