"""The port's training (``sonar_tpu_torch.training``) against ``sonar_tpu``'s
on the CPU, on small models whose weights come from JAX ``init_params``.

- the seven cases of ``tests/unit/test_training.py``: CE masking; the
  translation, classifier and distillation steps lower the loss; multiclass
  and unfrozen classifiers; remat leaves the gradients as they are; a
  checkpoint round trip (and a resumed run that matches an uninterrupted
  one);
- each loss and its gradients against ``jax.value_and_grad``, dropout off,
  fp32: the loss within 1e-5 of it, every gradient leaf within 1e-4 of its
  scale, the max-abs of JAX's leaf, floored at a thousandth of the largest
  leaf's (a key projection's bias has a gradient of exactly zero, softmax
  ignoring a constant per query, and reads as noise of ~1e-9); a tree with
  fused q/k/v gives ``qkv_proj`` the concatenation of JAX's three;
- three AdamW steps against ``optax.adamw``: parameters within 1e-5 of
  their scale, at eps 1e-4 (Adam divides each gradient element by its own
  root mean square plus eps, so where the gradient is zero, as for a key
  projection's bias, the fp32 noise of ~1e-9 becomes lr * 1e-9 / eps of
  update; at eps 1e-6 that reads 1.1e-5 to 1.2e-5 of the scale);
- dropout: seeded masks, the kept share within 3 sigma of 1 - p, kept
  values x / (1 - p) exactly, ``generator=None`` the identity;
- the kernel gates under autograd: each gated shape takes the plain version
  (the wrappers are patched to raise when handed tensors that autograd
  records) and gives every parameter a gradient, while under ``no_grad`` the
  same shapes still reach the wrappers;
- a rel-pos layer trained one step, then run through the kernel gate,
  agrees with the plain path (no stale per-head copy of r_proj).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from sonar_tpu.models.mutox.model import MutoxClassifier as JaxMutox, MutoxConfig  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jspeech_cfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeech  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jdec_archs  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_encoder_archs as jenc_archs  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.nn.conformer import ConformerConfig as JaxConformerConfig  # noqa: E402
from sonar_tpu.nn.core import init_linear as jinit_linear, linear as jlinear  # noqa: E402
from sonar_tpu.training import train_step as jts  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    mutox_from_numpy,
    speech_encoder_from_numpy,
    text_decoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.nn import conformer, core, transformer  # noqa: E402
from sonar_tpu_torch.nn.core import linear  # noqa: E402
from sonar_tpu_torch.ops import attention, gates  # noqa: E402
from sonar_tpu_torch.ops.cuda import attn_block, ffn, flash, relpos_flash, short_attn  # noqa: E402
from sonar_tpu_torch.ops.quantization import quantize_params_int8  # noqa: E402
from sonar_tpu_torch.training import checkpointing, train_step as ts  # noqa: E402

QKV = ("q_proj", "k_proj", "v_proj")


# -- trees and toys -------------------------------------------------------------------


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32) if np.asarray(a).dtype.kind
                                  == "f" else np.array(a), tree)


def _torch_tree(tree):
    """Fresh fp32 tensors of a numpy tree (each test trains its own)."""
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(np.array(v))
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _batch_to(batch, lib):
    return {k: (jnp.asarray(v) if lib == "jax" else torch.tensor(v)) for k, v in batch.items()}


def _toy_text(seed_enc=0, seed_dec=1):
    """JAX toy encoder + decoder weights (numpy) and a ragged batch."""
    enc = _np_tree(JaxEncoder(jenc_archs.get("toy")).init_params(jax.random.PRNGKey(seed_enc)))
    dec = _np_tree(JaxDecoder(jdec_archs.get("toy")).init_params(jax.random.PRNGKey(seed_dec)))
    rng = np.random.default_rng(0)
    batch = {
        "src_tokens": rng.integers(4, 1000, (4, 8)).astype(np.int32),
        "src_lens": np.array([8, 5, 8, 3], np.int32),
        "tgt_in": rng.integers(4, 1000, (4, 6)).astype(np.int32),
        "tgt_out": rng.integers(4, 1000, (4, 6)).astype(np.int32),
        "tgt_lens": np.array([6, 6, 2, 4], np.int32),
    }
    return enc, dec, batch


def _port_text_models(enc, dec):
    return (text_encoder_from_numpy(enc, sonar_text_encoder_archs.get("toy")),
            text_decoder_from_numpy(dec, sonar_text_decoder_archs.get("toy")))


def _speech_toy():
    cfg_j = jspeech_cfg.sonar_speech_encoder_archs.get("toy")
    params = _np_tree(JaxSpeech(cfg_j).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {
        "inputs": rng.normal(size=(4, 20, 8)).astype(np.float32),
        "lens": np.array([20, 16, 12, 20], np.int32),
        "teacher_emb": rng.normal(size=(4, 32)).astype(np.float32),
    }
    return JaxSpeech(cfg_j), params, batch


def _classifier_toy(classes=1, seed=0):
    enc = _np_tree(JaxEncoder(jenc_archs.get("toy")).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    if classes == 1:
        head = _np_tree(JaxMutox(MutoxConfig(input_size=32)).init_params(jax.random.PRNGKey(1)))
    else:
        head = _np_tree(jinit_linear(jax.random.PRNGKey(1), 32, classes))
    batch = {
        "tokens": rng.integers(4, 1000, (8, 8)).astype(np.int32),
        "lens": np.array([8, 3, 8, 6, 1, 8, 7, 5], np.int32),
        "labels": rng.integers(0, classes if classes > 1 else 2, (8,)).astype(np.int32),
    }
    return {"encoder": enc, "head": head}, batch


class _LinearHead:
    """A C-way linear head in both packages' calling conventions."""

    def apply(self, params, x):
        return jlinear(params, x)

    def forward_with(self, params, x):
        return linear(params, x)


def _port_head(head_np, classes):
    if classes == 1:
        return mutox_from_numpy(head_np, MutoxConfig(input_size=32), device="cpu")
    return _LinearHead()


def _jax_head(classes):
    return JaxMutox(MutoxConfig(input_size=32)) if classes == 1 else _LinearHead()


def _fused(tree):
    return transformer.fuse_qkv(tree, keep_split=False)


def _assert_grads_match(got, want):
    """got: {path: torch grad}; want: {path: JAX grad} (fused trees: the
    q/k/v of JAX concatenated for ``qkv_proj``)."""
    want = dict(want)
    for path in [p for p in want if "/self_attn/q_proj/" in p and p.replace(
            "/q_proj/", "/qkv_proj/") in got]:
        parts = [want.pop(path.replace("/q_proj/", f"/{n}/")) for n in QKV]
        want[path.replace("/q_proj/", "/qkv_proj/")] = np.concatenate(parts, axis=-1)
    assert got.keys() == want.keys()
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g is not None, path
        scale = max(np.abs(w).max(), floor)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * scale, (path, err, scale)


def _port_grads(tree):
    return {p: (None if t.grad is None else t.grad) for p, t in _flat(tree).items()}


def _requires_grad(tree):
    for t in _flat(tree).values():
        t.requires_grad_(True)
    return tree


# -- the seven cases of test_training.py ------------------------------------------------------


def test_cross_entropy_masking():
    logits = torch.zeros((1, 3, 4))  # uniform -> CE = log(4)
    labels = torch.tensor([[0, 1, 2]])
    mask = torch.tensor([[1, 1, 0]])
    np.testing.assert_allclose(float(ts.cross_entropy(logits, labels, mask)), np.log(4.0),
                               rtol=1e-6)
    assert float(ts.cross_entropy(logits, labels, torch.zeros_like(mask))) == 0.0


def _translation_state(make_optimizer, fused=False):
    enc, dec, batch = _toy_text()
    encoder, decoder = _port_text_models(enc, dec)
    params = {"encoder": _torch_tree(enc), "decoder": _torch_tree(dec)}
    if fused:
        params = {k: _fused(v) for k, v in params.items()}

    def loss_fn(p, b, gen):
        return ts.translation_loss(encoder, decoder, p["encoder"], p["decoder"], b, gen)

    return ts.init_train_state(params, make_optimizer), loss_fn, _batch_to(batch, "torch")


def test_translation_train_step_reduces_loss():
    state, loss_fn, batch = _translation_state(lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
    step = ts.make_train_step(loss_fn)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(8):
        state, loss = step(state, batch, gen)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    assert state.step == 8


def test_checkpoint_roundtrip(tmp_path):
    """Params, optimizer state and step come back; a run resumed from the
    checkpoint after 2 steps gives the losses of an uninterrupted one."""
    def make(leaves):
        return torch.optim.AdamW(leaves, lr=1e-3, weight_decay=1e-2)

    state, loss_fn, batch = _translation_state(make)
    step = ts.make_train_step(loss_fn)
    for _ in range(2):
        state, _ = step(state, batch)
    checkpointing.save_train_state(tmp_path / "ckpt.pt", state)
    straight = [float(step(state, batch)[1]) for _ in range(3)]

    fresh, _, _ = _translation_state(make)
    back = checkpointing.restore_train_state(tmp_path / "ckpt.pt", fresh)
    assert back.step == 2 and back.params is fresh.params
    saved = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    for path, t in _flat(back.params).items():
        assert torch.equal(t, _flat(saved["params"])[path]), path
        assert t.requires_grad
    for a, b in zip(core.tree_leaves(back.params), back.optimizer.param_groups[0]["params"]):
        assert a is b  # the optimizer still steps the template's tensors
    resumed = []
    for _ in range(3):
        back, loss = step(back, batch)
        resumed.append(float(loss))
    assert resumed == straight and back.step == 5

    other = ts.init_train_state({"x": torch.zeros(2)}, make)
    with pytest.raises(ValueError, match="keys"):
        checkpointing.restore_train_state(tmp_path / "ckpt.pt", other)


@pytest.mark.parametrize("model", ["encoder", "decoder", "conformer"])
def test_remat_gradients_match(model):
    """``remat=True`` (``torch.utils.checkpoint``) must not change the
    gradients, only the memory."""
    def grads(remat):
        if model == "conformer":
            jmodel, params, batch = _speech_toy()
            m = speech_encoder_from_numpy(params, sonar_speech_encoder_archs.get("toy"))
            m.remat = remat
            tree = _requires_grad(_torch_tree(params))
            out = m.forward_with(tree, torch.tensor(batch["inputs"]), torch.tensor(batch["lens"]))
            out.sentence_embeddings.square().sum().backward()
            return _port_grads(tree)
        enc, dec, batch = _toy_text()
        encoder, decoder = _port_text_models(enc, dec)
        encoder.remat = decoder.remat = remat
        params = _requires_grad({"encoder": _torch_tree(enc), "decoder": _torch_tree(dec)})
        b = _batch_to(batch, "torch")
        emb = encoder.forward_with(params["encoder"], b["src_tokens"], b["src_lens"])
        if model == "encoder":
            emb.sentence_embeddings.square().sum().backward()
        else:
            logits = decoder.forward_with(params["decoder"], b["tgt_in"], b["tgt_lens"],
                                          emb.sentence_embeddings[:, None].detach())
            logits.square().mean().backward()
        return _port_grads(params[model])

    plain, remat = grads(False), grads(True)
    assert plain.keys() == remat.keys()
    for path in plain:
        assert plain[path] is not None, path
        torch.testing.assert_close(remat[path], plain[path], rtol=0, atol=1e-6)


def test_classifier_train_step_reduces_loss():
    """Frozen-encoder MLP-head fine-tuning: the frozen encoder gets no
    gradient, the head does, and the loss falls over 8 Adam steps."""
    params_np, batch = _classifier_toy()
    encoder = text_encoder_from_numpy(params_np["encoder"], sonar_text_encoder_archs.get("toy"))
    head = _port_head(params_np["head"], 1)
    b = _batch_to(batch, "torch")

    def loss_fn(p, bb, gen):
        return ts.classifier_loss(encoder, head, p, bb, gen)

    params = _requires_grad(_torch_tree(params_np))
    loss_fn(params, b, None).backward()
    assert all(t.grad is None for t in _flat(params["encoder"]).values())
    assert sum(float(t.grad.abs().sum()) for t in _flat(params["head"]).values()) > 0

    state = ts.init_train_state(_torch_tree(params_np),
                                lambda leaves: torch.optim.Adam(leaves, lr=1e-2))
    before = {p: t.clone() for p, t in _flat(state.params["encoder"]).items()}
    step = ts.make_train_step(loss_fn)
    losses = []
    for _ in range(8):
        state, loss = step(state, b, torch.Generator().manual_seed(0))
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses
    for p, t in _flat(state.params["encoder"]).items():
        assert torch.equal(t, before[p]), p


def test_classifier_loss_multiclass_and_unfrozen():
    params_np, batch = _classifier_toy(classes=5, seed=1)
    encoder = text_encoder_from_numpy(params_np["encoder"], sonar_text_encoder_archs.get("toy"))
    head = _LinearHead()
    b = _batch_to(batch, "torch")
    assert np.isfinite(float(ts.classifier_loss(encoder, head, _torch_tree(params_np), b)))
    params = _requires_grad(_torch_tree(params_np))
    ts.classifier_loss(encoder, head, params, b, freeze_encoder=False).backward()
    assert sum(float(t.grad.abs().sum()) for t in _flat(params["encoder"]).values()) > 0


def test_distillation_train_step_reduces_loss():
    """A speech student distilled towards fixed teacher embeddings; the
    cosine objective is bounded; an unknown objective raises; a text
    student takes a dropout generator."""
    _, params_np, batch = _speech_toy()
    model = speech_encoder_from_numpy(params_np, sonar_speech_encoder_archs.get("toy"))
    b = _batch_to(batch, "torch")
    step = ts.make_train_step(lambda p, bb, gen: ts.distillation_loss(model, p, bb))
    state = ts.init_train_state(_torch_tree(params_np),
                                lambda leaves: torch.optim.Adam(leaves, lr=1e-3))
    losses = []
    for _ in range(8):
        state, loss = step(state, b)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses

    c = float(ts.distillation_loss(model, _torch_tree(params_np), b, objective="cosine"))
    assert 0.0 <= c <= 2.0
    with pytest.raises(ValueError, match="objective"):
        ts.distillation_loss(model, _torch_tree(params_np), b, objective="nope")

    enc, _, _ = _toy_text()
    tmodel = text_encoder_from_numpy(enc, sonar_text_encoder_archs.get("toy"))
    rng = np.random.default_rng(0)
    tbatch = {"inputs": torch.tensor(rng.integers(4, 900, (4, 10)), dtype=torch.int32),
              "lens": torch.tensor([10, 8, 6, 10], dtype=torch.int32),
              "teacher_emb": torch.tensor(rng.normal(size=(4, 32)), dtype=torch.float32)}
    t = ts.distillation_loss(tmodel, _torch_tree(enc), tbatch,
                             generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(t))


# -- against jax.value_and_grad --------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused"])
def test_translation_loss_and_grads_match_jax(fused):
    enc, dec, batch = _toy_text()
    je, jd = JaxEncoder(jenc_archs.get("toy")), JaxDecoder(jdec_archs.get("toy"))
    jb = _batch_to(batch, "jax")
    want, jgrads = jax.value_and_grad(lambda p: jts.translation_loss(
        je, jd, p["encoder"], p["decoder"], jb))({"encoder": enc, "decoder": dec})

    encoder, decoder = _port_text_models(enc, dec)
    params = {"encoder": _torch_tree(enc), "decoder": _torch_tree(dec)}
    if fused:
        params = {k: _fused(v) for k, v in params.items()}
    _requires_grad(params)
    loss = ts.translation_loss(encoder, decoder, params["encoder"], params["decoder"],
                               _batch_to(batch, "torch"))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads_match(_port_grads(params), _flat(_np_tree(jgrads)))


@pytest.mark.parametrize("objective", ["mse", "cosine"])
def test_distillation_loss_and_grads_match_jax(objective):
    jmodel, params_np, batch = _speech_toy()
    want, jgrads = jax.value_and_grad(lambda p: jts.distillation_loss(
        jmodel, p, _batch_to(batch, "jax"), objective=objective))(params_np)
    model = speech_encoder_from_numpy(params_np, sonar_speech_encoder_archs.get("toy"))
    params = _requires_grad(_torch_tree(params_np))
    loss = ts.distillation_loss(model, params, _batch_to(batch, "torch"), objective=objective)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _assert_grads_match(_port_grads(params), _flat(_np_tree(jgrads)))


@pytest.mark.parametrize("classes,freeze", [(1, True), (1, False), (5, False)])
def test_classifier_loss_and_grads_match_jax(classes, freeze):
    params_np, batch = _classifier_toy(classes, seed=classes)
    je = JaxEncoder(jenc_archs.get("toy"))
    want, jgrads = jax.value_and_grad(lambda p: jts.classifier_loss(
        je, _jax_head(classes), p, _batch_to(batch, "jax"), freeze_encoder=freeze))(params_np)
    encoder = text_encoder_from_numpy(params_np["encoder"], sonar_text_encoder_archs.get("toy"))
    params = _requires_grad(_torch_tree(params_np))
    loss = ts.classifier_loss(encoder, _port_head(params_np["head"], classes), params,
                              _batch_to(batch, "torch"), freeze_encoder=freeze)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    want_grads = _flat(_np_tree(jgrads))
    got = _port_grads(params)
    if freeze:  # JAX's stop_gradient gives zeros; the port's no_grad gives none
        for path in [p for p in got if p.startswith("/encoder/")]:
            assert got.pop(path) is None and not want_grads.pop(path).any(), path
    _assert_grads_match(got, want_grads)


def test_three_adamw_steps_match_optax():
    enc, dec, batch = _toy_text()
    je, jd = JaxEncoder(jenc_archs.get("toy")), JaxDecoder(jdec_archs.get("toy"))
    hyper = dict(b1=0.8, b2=0.95, eps=1e-4, weight_decay=0.05)
    opt = optax.adamw(3e-3, **hyper)
    jstep = jax.jit(jts.make_train_step(lambda p, b, r: jts.translation_loss(
        je, jd, p["encoder"], p["decoder"], b), opt))
    jstate = jts.init_train_state({"encoder": enc, "decoder": dec}, opt)
    jb = _batch_to(batch, "jax")
    for _ in range(3):
        jstate, _ = jstep(jstate, jb, jax.random.PRNGKey(0))

    state, loss_fn, b = _translation_state(lambda leaves: torch.optim.AdamW(
        leaves, lr=3e-3, betas=(hyper["b1"], hyper["b2"]), eps=hyper["eps"],
        weight_decay=hyper["weight_decay"]))
    step = ts.make_train_step(loss_fn)
    for _ in range(3):
        state, _ = step(state, b)
    want = _flat(_np_tree(jstate.params))
    got = _flat(state.params)
    assert got.keys() == want.keys()
    for path, w in want.items():
        err = np.abs(got[path].detach().numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (path, err)


# -- dropout ----------------------------------------------------------------------------------


def test_dropout_is_seeded():
    """The same seed gives the same loss twice, another seed another loss,
    and no generator the loss of no dropout."""
    state, loss_fn, batch = _translation_state(lambda leaves: torch.optim.SGD(leaves, lr=0.0))

    def loss(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return float(loss_fn(state.params, batch, gen))

    assert loss(3) == loss(3)
    assert loss(3) != loss(4)
    assert loss(None) not in (loss(3), loss(4))


def test_dropout_mask():
    x = torch.randn(1000, 1000, generator=torch.Generator().manual_seed(0)) + 5.0
    p = 0.1
    y = core.dropout(x, p, torch.Generator().manual_seed(1))
    kept = y != 0
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) <= 3 * np.sqrt(p * (1 - p) / n)
    assert torch.equal(y[kept], x[kept] / (1 - p))
    yb = core.dropout(x.bfloat16(), p, torch.Generator().manual_seed(1))
    assert yb.dtype == torch.bfloat16 and torch.equal(yb != 0, kept)
    assert torch.equal(yb[kept], x.bfloat16()[kept] / (1 - p))
    assert core.dropout(x, p, None) is x
    assert core.dropout(x, 0.0, torch.Generator()) is x


# -- kernel gates under autograd ---------------------------------------------------------------


def _guard(monkeypatch, module, name, calls):
    """Patch a kernel wrapper to count its calls and to raise when handed a
    tensor that autograd records (its CUDA kernel has no backward)."""
    wrapped = getattr(module, name)

    def guarded(*args, **kwargs):
        tensors = [a for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor)]
        if gates.records_grad(*tensors):
            raise AssertionError(f"{name} called on tensors that autograd records")
        calls[name] = calls.get(name, 0) + 1
        return wrapped(*args, **kwargs)

    monkeypatch.setattr(module, name, guarded)


def _float_tree(tree):
    return {k: _float_tree(v) if isinstance(v, dict) else v for k, v in tree.items()
            if isinstance(v, dict) or v.is_floating_point()}


def _gate_case(case):
    """(forward(params) -> output, params) reaching one gate's kernel."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)

    def lin(i, o):
        return {"kernel": torch.randn(i, o, generator=gen) * i ** -0.5,
                "bias": torch.randn(o, generator=gen) * 0.1}

    def ln(d):
        return {"weight": 1 + 0.1 * torch.randn(d, generator=gen),
                "bias": 0.1 * torch.randn(d, generator=gen)}

    def layer(d, f):
        return {"self_attn": {n: lin(d, d) for n in (*QKV, "output_proj")},
                "self_attn_layer_norm": ln(d), "ffn": {"inner_proj": lin(d, f),
                                                       "output_proj": lin(f, d)},
                "ffn_layer_norm": ln(d)}

    def bias_of(lens, s):
        pos = torch.arange(s)[None, :]
        return torch.where(pos < torch.tensor(lens)[:, None], 0.0,
                           torch.finfo(torch.float32).min)[:, None, None, :]

    if case in ("short_qkv_attention", "flash_attention"):
        s = 40 if case == "short_qkv_attention" else 260
        params = transformer.fuse_qkv(layer(128, 256), keep_split=False)
        x = torch.randn(2, s, 128, generator=gen)
        bias = bias_of([s, s - 13], s)
        return (lambda p: transformer.encoder_layer(p, x, bias, 2, "relu")), params
    if case in ("fused_attn_block", "fused_attn_block_long", "fused_int8_ffn"):
        # int8 layers with 2048 tokens or more: the block kernels at S 128
        # and at S 384 (the attention step in two passes); the int8 FFN
        # alone at S 4, below the block gate's S 8.
        s = {"fused_attn_block": 128, "fused_attn_block_long": 384, "fused_int8_ffn": 4}[case]
        params = quantize_params_int8(transformer.fuse_qkv(layer(128, 256), keep_split=False))
        x = torch.randn(-(-2048 // s), s, 128, generator=gen)
        bias = bias_of([s] * x.shape[0], s)
        return (lambda p: transformer.encoder_layer(p, x, bias, 2, "relu")), params
    # rel-pos v2: a Conformer block at D 128, two heads of 64, S 130.
    cfg = conformer.ConformerConfig(model_dim=128, num_layers=1, num_heads=2, ffn_inner_dim=256,
                                    depthwise_kernel_size=7)
    jparams = _np_tree(__import__("sonar_tpu.nn.conformer", fromlist=["x"]).init_conformer_block(
        jax.random.PRNGKey(0), JaxConformerConfig(model_dim=128, num_layers=1, num_heads=2,
                                                  ffn_inner_dim=256, depthwise_kernel_size=7)))
    jparams["self_attn"]["sdpa"]["v_bias"] = rng.normal(size=(2, 64)).astype(np.float32) * 0.1
    params = _torch_tree(jparams)
    x = torch.randn(2, 130, 128, generator=gen)
    lens = [130, 101]
    mask = torch.arange(130)[None, :] < torch.tensor(lens)[:, None]
    return (lambda p: conformer.conformer_block(p, x, bias_of(lens, 130), mask, cfg)), params


GATES = {  # case -> the wrappers its inference forward reaches
    "short_qkv_attention": [(short_attn, "short_qkv_attention")],
    "flash_attention": [(flash, "flash_attention")],
    "fused_attn_block": [(attn_block, "fused_attn_block"), (ffn, "fused_int8_ffn_ln")],
    "fused_attn_block_long": [(attn_block, "fused_attn_block"), (ffn, "fused_int8_ffn_ln")],
    "fused_int8_ffn": [(ffn, "fused_int8_ffn")],
    "relpos_flash_attention_v2": [(relpos_flash, "relpos_flash_attention_v2")],
}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_take_the_plain_path_under_autograd(case, monkeypatch):
    calls = {}
    for module, name in GATES[case]:
        _guard(monkeypatch, module, name, calls)
    forward, params = _gate_case(case)
    with torch.no_grad():
        want = forward(params)
    assert sorted(calls) == sorted(name for _, name in GATES[case])  # inference: kernels

    calls.clear()
    trained = _float_tree(params)
    _requires_grad(trained)
    got = forward(params)
    assert not calls and got.requires_grad
    (got.float().square().mean()).backward()
    for path, t in _flat(trained).items():
        assert t.grad is not None and bool(t.grad.abs().sum() > 0), path
    # The plain version computes the kernel's function.
    tol = 2e-2 if case.startswith(("fused_attn_block", "fused_int8_ffn")) else 1e-5
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=tol * float(want.abs().max()))


def test_records_grad():
    a = torch.zeros(2)
    b = torch.zeros(2, requires_grad=True)
    assert not gates.records_grad(a, None) and gates.records_grad(a, b, None)
    with torch.no_grad():
        assert not gates.records_grad(b)
    with torch.inference_mode():
        assert not gates.records_grad(b)


def test_dispatch_sdpa_under_autograd(monkeypatch):
    """``dispatch_sdpa`` on its own: S 300 reaches flash under no_grad and
    the plain ``sdpa`` when q requires grad."""
    calls = {}
    _guard(monkeypatch, flash, "flash_attention", calls)
    q, k, v = (torch.randn(1, 2, 300, 64, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    with torch.no_grad():
        attention.dispatch_sdpa(q, k, v)
    assert calls == {"flash_attention": 1}
    q.requires_grad_(True)
    attention.dispatch_sdpa(q, k, v).sum().backward()
    assert calls == {"flash_attention": 1} and q.grad is not None


# -- rel-pos weights after a step ----------------------------------------------------------------


def _wide_speech():
    base = sonar_speech_encoder_archs.get("toy")
    jbase = jspeech_cfg.sonar_speech_encoder_archs.get("toy")
    kw = dict(model_dim=128, num_layers=2, num_heads=2, ffn_inner_dim=256,
              depthwise_kernel_size=7)
    wide = dict(model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256)
    jcfg = dataclasses.replace(jbase, conformer=JaxConformerConfig(**kw), frontend=dataclasses.replace(
        jbase.frontend, num_fbank_channels=80, model_dim=128), **wide)
    tcfg = dataclasses.replace(base, conformer=conformer.ConformerConfig(**kw),
                               frontend=dataclasses.replace(base.frontend, num_fbank_channels=80,
                                                            model_dim=128), **wide)
    return jcfg, tcfg


def test_relpos_layer_after_a_step_matches_the_plain_path(monkeypatch):
    """An inference forward at S 150, one Adam step on the speech encoder's
    own tree (r_proj changes), then the forward again: through the kernel
    gate (the wrapper's plain version on the CPU, fed r_proj per head as the
    kernel is) it gives what the plain path gives, and no longer what it
    gave before the step."""
    jcfg, tcfg = _wide_speech()
    params_np = _np_tree(JaxSpeech(jcfg).init_params(jax.random.PRNGKey(0)))
    model = speech_encoder_from_numpy(params_np, tcfg)
    tree = model.params.tree()
    r_proj = tree["encoder"]["layers"]["self_attn"]["sdpa"]["r_proj"]["kernel"]
    before = r_proj.clone()
    rng = np.random.default_rng(1)
    fb = torch.tensor(rng.normal(size=(2, 300, 80)).astype(np.float32))
    lens = torch.tensor([300, 260])
    batch = {"inputs": fb, "lens": lens,
             "teacher_emb": torch.tensor(rng.normal(size=(2, 128)).astype(np.float32))}
    calls = {}
    _guard(monkeypatch, relpos_flash, "relpos_flash_attention_v2", calls)
    with torch.inference_mode():
        served = model(fb, lens).sentence_embeddings
    # Adam moves every element by about lr, whatever its gradient's size.
    state = ts.init_train_state(tree, lambda leaves: torch.optim.Adam(leaves, lr=0.05))
    ts.make_train_step(lambda p, b, g: ts.distillation_loss(model, p, b))(state, batch)
    assert (r_proj - before).abs().mean() > 0.3 * before.abs().mean()
    with torch.inference_mode():
        via_gate = model(fb, lens).sentence_embeddings
        assert calls == {"relpos_flash_attention_v2": 4} and not torch.equal(via_gate, served)
        monkeypatch.setattr(conformer, "_use_relpos_kernel", lambda *a: False)
        plain = model(fb, lens).sentence_embeddings
    torch.testing.assert_close(via_gate, plain, rtol=0, atol=1e-5 * float(plain.abs().max()))


# -- the precision scope of a step ----------------------------------------------------------------


def test_step_runs_in_the_fp32_scope(monkeypatch):
    """The loss and its backward run inside the fp32 precision scope, and the
    caller's flags are back after the step."""
    from sonar_tpu_torch.ops import precision

    depth = []
    state, loss_fn, batch = _translation_state(lambda leaves: torch.optim.SGD(leaves, lr=0.1))

    def probe(p, b, g):
        loss = loss_fn(p, b, g)
        depth.append(precision._FP32.depth)
        return loss * 1.0

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    ts.make_train_step(probe)(state, batch)
    assert depth == [1] and precision._FP32.depth == 0
    assert (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()) == flags
