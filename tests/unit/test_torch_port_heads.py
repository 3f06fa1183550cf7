"""The port's BLASER, MuTox and LASER2 heads against ``sonar_tpu``'s on CPU.

Weights are torch-style flat state dicts drawn from a numpy seed (the
layout of the published checkpoints), mapped into both packages by their
own bridges. Tolerances: fp32 outputs to atol 1e-5 (MLPs and a 2-layer
bi-LSTM of fp32 products summed in another order); weight trees and
tokenizer ids exactly.

LASER2: the JAX scan freezes its state outside each sequence, the port's
packed ``nn.LSTM`` writes the padding value there; only the valid
positions and the -inf-padded max-pool are held equal, which is what the
model returns.
"""

import dataclasses
import os
from pathlib import Path
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.inference_pipelines import speech as jspeech  # noqa: E402
from sonar_tpu.inference_pipelines.mutox_speech import (  # noqa: E402
    MutoxSpeechClassifierPipeline as JaxMutoxPipeline,
)
from sonar_tpu.models import blaser as jblaser  # noqa: E402
from sonar_tpu.models import laser2_text as jlaser  # noqa: E402
from sonar_tpu.models import mutox as jmutox  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jscfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeechEncoder  # noqa: E402
from sonar_tpu.nn.lstm import bilstm_stack as jax_bilstm  # noqa: E402
from sonar_tpu.tokenizers.laser2 import Laser2Tokenizer as JaxLaser2Tokenizer  # noqa: E402
from sonar_tpu.tokenizers.spm_proto import (  # noqa: E402
    PIECE_CONTROL, PIECE_UNKNOWN, ModelProto, NormalizerSpecProto, SentencePieceProto as P,
    TrainerSpecProto, serialize_model_proto,
)
from sonar_tpu_torch.assets import convert  # noqa: E402
from sonar_tpu_torch.inference_pipelines.mutox_speech import MutoxSpeechClassifierPipeline  # noqa: E402
from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder  # noqa: E402
from sonar_tpu_torch.models import blaser, laser2_text, mutox  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.nn import lstm  # noqa: E402
from sonar_tpu_torch.tokenizers.laser2 import Laser2Tokenizer  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


def _flat_mlp(rng, prefix, dims, index):
    """A torch Linear stack's state: ``{prefix}.{index(i)}.weight`` [out, in]."""
    flat = {}
    for i in range(len(dims) - 1):
        bound = dims[i] ** -0.5
        flat[f"{prefix}.{index(i)}.weight"] = rng.uniform(
            -bound, bound, (dims[i + 1], dims[i])).astype(np.float32)
        flat[f"{prefix}.{index(i)}.bias"] = rng.uniform(-bound, bound, dims[i + 1]).astype(
            np.float32)
    return flat


def _blaser_state(cfg, seed=0):
    """The reference Sequential's keys: Dropout at 0, then Linear, Tanh,
    Dropout per hidden layer, then the output Linear."""
    dims = [cfg.feature_dim] + cfg.hidden_dims + [cfg.output_dim]
    return _flat_mlp(np.random.default_rng(seed), "mlp", dims, lambda i: 1 + 3 * i)


def _mutox_state(input_size=1024, seed=0):
    return _flat_mlp(np.random.default_rng(seed), "model_all", [input_size, 512, 128, 1],
                     lambda i: f"{i}.1")


def _tree_equal(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert {jax.tree_util.keystr(p) for p, _ in flat_g} == {jax.tree_util.keystr(p) for p in flat_w}
    for path, leaf in flat_g:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_w[path]))


# -- BLASER ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["basic_ref", "basic_qe"])
def test_blaser_matches_jax(arch):
    cfg, jcfg = blaser.blaser_archs.get(arch), jblaser.blaser_archs.get(arch)
    flat = _blaser_state(cfg)
    params = blaser.blaser_params_from_torch(flat)
    _tree_equal(params, jblaser.blaser_params_from_torch(flat))
    model = convert.blaser_from_numpy(params, cfg, "cpu")
    rng = np.random.default_rng(1)
    src, mt, ref = (rng.normal(size=(5, 1024)).astype(np.float32) for _ in range(3))
    got = model(src, mt, ref)
    want = jblaser.BlaserModel(jcfg).apply(params, jnp.asarray(src), jnp.asarray(mt),
                                           jnp.asarray(ref))
    assert got.shape == (5, 1) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if arch == "basic_qe":  # QE ignores the reference
        assert torch.equal(model(src, mt), got)
    else:  # COMET requires it
        with pytest.raises(ValueError, match="reference"):
            model(src, mt)


def test_blaser_configs_and_init():
    with pytest.raises(ValueError):
        blaser.BlaserConfig(input_form="NOPE")
    with pytest.raises(ValueError):
        blaser.BlaserConfig(activation="gelu")
    with pytest.raises(KeyError):
        blaser.blaser_archs.get("nope")
    cfg = dataclasses.replace(blaser.blaser_archs.get("basic_qe"), output_act=True, norm_emb=False)
    jcfg = dataclasses.replace(jblaser.blaser_archs.get("basic_qe"), output_act=True,
                               norm_emb=False)
    params = convert.init_blaser_params(cfg, seed=3)
    want_shapes = jax.tree_util.tree_map(np.shape, jblaser.BlaserModel(jcfg).init_params(
        jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(np.shape, params) == want_shapes
    x = np.random.default_rng(2).normal(size=(3, 1024)).astype(np.float32) * 3
    got = convert.blaser_from_numpy(params, cfg, "cpu")(x, x * 0.5)
    want = jblaser.BlaserModel(jcfg).apply(params, jnp.asarray(x), jnp.asarray(x * 0.5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.abs().max()) <= 1.0


# -- MuTox ------------------------------------------------------------------------------


def test_mutox_matches_jax():
    flat = _mutox_state()
    params = mutox.mutox_params_from_torch(flat)
    _tree_equal(params, jmutox.mutox_params_from_torch(flat))
    cfg = mutox.mutox_archs.get("mutox")
    model = convert.mutox_from_numpy(params, cfg, "cpu")
    x = np.random.default_rng(3).normal(size=(6, 1024)).astype(np.float32)
    jmodel = jmutox.MutoxClassifier(jmutox.mutox_archs.get("mutox"))
    for prob in (False, True):
        got, want = model(x, prob), jmodel.apply(params, jnp.asarray(x), prob)
        assert got.shape == (6, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert jax.tree_util.tree_map(np.shape, convert.init_mutox_params(cfg)) == \
        jax.tree_util.tree_map(np.shape, jmodel.init_params(jax.random.PRNGKey(0)))


def test_mutox_speech_pipeline_matches_jax():
    """Toy speech encoder (D 32) into a MuTox classifier of input 32: the
    port's pipeline gives the JAX pipeline's scores and probabilities."""
    scfg = jscfg.sonar_speech_encoder_archs.get("toy")
    sparams = jax.tree_util.tree_map(np.asarray, JaxSpeechEncoder(scfg).init_params(
        jax.random.PRNGKey(0)))
    params = mutox.mutox_params_from_torch(_mutox_state(32, seed=4))
    jenc = jspeech.JitSpeechEncoder(JaxSpeechEncoder(scfg), sparams)
    jpipe = JaxMutoxPipeline((jmutox.MutoxClassifier(jmutox.MutoxConfig(32)), params), jenc)
    tenc = TorchSpeechEncoder(convert.speech_encoder_from_numpy(
        sparams, sonar_speech_encoder_archs.get("toy")), device="cpu")
    pipe = MutoxSpeechClassifierPipeline(
        convert.mutox_from_numpy(params, mutox.MutoxConfig(32), "cpu"), tenc, device="cpu")
    rng = np.random.default_rng(5)
    clips = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (9000, 20000, 300, 16000)]
    for prob in (False, True):
        got = pipe.predict(clips, batch_size=3, output_prob=prob)
        want = jpipe.predict(clips, batch_size=3, output_prob=prob)
        assert got.shape == (4, 1)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_mutox_speech_pipeline_refuses_a_classifier_on_another_device():
    """The embeddings stay on the encoder's device: a classifier elsewhere
    raises instead of having them copied to it."""
    scfg = sonar_speech_encoder_archs.get("toy")
    tenc = TorchSpeechEncoder(convert.speech_encoder_from_numpy(
        convert.init_speech_encoder_params(scfg, 0), scfg), device="cpu")
    params = convert.init_mutox_params(mutox.MutoxConfig(32))
    with pytest.raises(ValueError, match="on meta and the speech encoder on cpu"):
        MutoxSpeechClassifierPipeline(
            convert.mutox_from_numpy(params, mutox.MutoxConfig(32), "meta"), tenc)
    pipe = MutoxSpeechClassifierPipeline(
        convert.mutox_from_numpy(params, mutox.MutoxConfig(32), "cpu"), tenc)
    assert pipe.mutox_classifier.device == pipe.model.device == torch.device("cpu")


# -- LASER2 ------------------------------------------------------------------------------


def _laser_state(cfg, seed=0):
    """A torch ``LaserLstmEncoder`` state (embedding with a zero pad row)."""
    rng = np.random.default_rng(seed)
    emb = (rng.standard_normal((cfg.vocabulary_size, cfg.model_dim)) * 0.3).astype(np.float32)
    emb[cfg.pad_idx] = 0.0
    flat = {"embed_tokens.weight": emb}
    h, bound = cfg.hidden_size, cfg.hidden_size ** -0.5
    in_dim = cfg.model_dim
    for layer in range(cfg.num_layers):
        for d in ("", "_reverse"):
            for name, shape in (("weight_ih", (4 * h, in_dim)), ("weight_hh", (4 * h, h)),
                                ("bias_ih", (4 * h,)), ("bias_hh", (4 * h,))):
                flat[f"lstm.{name}_l{layer}{d}"] = rng.uniform(-bound, bound, shape).astype(
                    np.float32)
        in_dim = 2 * h
    return flat


SEQS = np.asarray([[4, 5, 6, 7, 9, 1], [8, 9, 10, 1, 1, 1], [11, 1, 1, 1, 1, 1]], np.int32)
LENS = np.asarray([5, 3, 1], np.int32)


def _laser_models():
    cfg = laser2_text.laser2_archs.get("toy")
    flat = _laser_state(cfg)
    params = laser2_text.laser2_params_from_torch(flat)
    _tree_equal(params, jlaser.laser2_params_from_torch(flat))
    return cfg, params, convert.laser2_from_numpy(params, cfg, device="cpu")


def test_laser2_matches_jax():
    cfg, params, model = _laser_models()
    got = model(SEQS, LENS)
    want = jlaser.LaserLstmEncoder(jlaser.laser2_archs.get("toy")).apply(
        params, jnp.asarray(SEQS), jnp.asarray(LENS))
    assert got.shape == (3, 48) and model.output_units == 48
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_lstm_valid_positions_match_jax_and_padding_differs():
    """The stack's outputs agree at every valid position; past a
    sequence's end the JAX scan repeats the last valid forward state,
    the packed run holds the padding value (0)."""
    cfg, params, model = _laser_models()
    x = torch.tensor(params["embed_tokens"]["weight"])[torch.tensor(SEQS).long()].transpose(0, 1)
    with torch.inference_mode():
        got = lstm.bilstm_stack(model.lstm, x, LENS).numpy()
    want = np.asarray(jax_bilstm(params["lstm"], jnp.asarray(x.numpy()), jnp.asarray(LENS),
                                 cfg.hidden_size, cfg.num_layers))
    valid = np.arange(SEQS.shape[1])[:, None] < LENS[None, :]
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5)
    assert np.all(got[~valid] == 0.0)
    np.testing.assert_allclose(want[5, 1, :24], want[2, 1, :24], atol=0)  # JAX: frozen state


def test_laser2_batching_invariance():
    """A right-padded batch gives each sentence's embedding run alone, and
    a longer padding changes nothing."""
    _, _, model = _laser_models()
    batch = model(SEQS, LENS)
    for r in range(3):
        alone = model(SEQS[r:r + 1, : LENS[r]], LENS[r:r + 1])
        np.testing.assert_allclose(alone.numpy()[0], batch.numpy()[r], atol=1e-5)
    wider = np.concatenate([SEQS, np.ones((3, 4), np.int32)], axis=1)
    np.testing.assert_allclose(model(wider, LENS).numpy(), batch.numpy(), atol=1e-6)


def test_laser2_init_has_the_jax_layout():
    cfg = laser2_text.laser2_archs.get("toy")
    got = jax.tree_util.tree_map(np.shape, convert.init_laser2_params(cfg, seed=1))
    want = jax.tree_util.tree_map(np.shape, jlaser.LaserLstmEncoder(
        jlaser.laser2_archs.get("toy")).init_params(jax.random.PRNGKey(0)))
    assert got == want
    full = laser2_text.laser2_archs.get("laser2")
    assert (full.vocabulary_size, full.pad_idx, full.model_dim, full.hidden_size,
            full.num_layers, full.bidirectional) == (50004, 1, 320, 512, 5, True)


def _laser_spm(tmp_path):
    pieces = [P("<unk>", 0.0, PIECE_UNKNOWN), P("<s>", 0.0, PIECE_CONTROL),
              P("</s>", 0.0, PIECE_CONTROL)]
    pieces += [P("▁" + w, -1.0) for w in ("hello", "world", "the", "cat", "sat", "on")]
    pieces += [P(c, -5.0) for c in "abcdefghijklmnopqrstuvwxyz"] + [P("▁", -4.0)]
    proto = ModelProto(pieces=pieces, trainer=TrainerSpecProto(unk_id=0, bos_id=1, eos_id=2,
                                                              pad_id=-1),
                       normalizer=NormalizerSpecProto())
    path = tmp_path / "laser2.spm"
    path.write_bytes(serialize_model_proto(proto))
    return path


def test_laser2_tokenizer_matches_jax(tmp_path):
    path = _laser_spm(tmp_path)
    tok, jtok = Laser2Tokenizer(path), JaxLaser2Tokenizer(path)
    assert tok.vocab_info == type(tok.vocab_info)(**dataclasses.asdict(jtok.vocab_info))
    enc, jenc = tok.create_encoder(), jtok.create_encoder()
    for text in ("hello world", "the cat sat on the mat", "qz", ""):
        ids = enc(text)
        assert ids == jenc(text) and ids[-1] == 2
        assert tok.create_decoder()(tok.create_raw_encoder()(text)) == text


def test_heads_load_through_the_hubs(tmp_path):
    """Checkpoints behind model cards load through the port's hub (and its
    ``get_*_hub()`` getters) and score as the JAX hub's models do."""
    from sonar_tpu.assets import hub as jax_hub
    from sonar_tpu.assets.store import ModelCard, TokenizerCard, default_store
    from sonar_tpu_torch.assets import hub
    from sonar_tpu_torch.assets import store as port_store

    cfg = laser2_text.laser2_archs.get("toy")
    states = {"blaser": ("basic_qe", _blaser_state(blaser.blaser_archs.get("basic_qe"))),
              "mutox": ("mutox", _mutox_state()), "laser2": ("toy", _laser_state(cfg))}
    store, pstore = default_store(), port_store.default_store()
    names = []
    for family, (arch, flat) in states.items():
        path = tmp_path / f"{family}.pt"
        torch.save({k: torch.tensor(v) for k, v in flat.items()}, path)
        name = f"torch_port_{family}_test_card"
        names.append(name)
        store.register_model(ModelCard(name=name, family=family, arch=arch, checkpoint=str(path)))
        pstore.register_model(port_store.ModelCard(name=name, family=family, arch=arch,
                                                   checkpoint=str(path)))
    spm = str(_laser_spm(tmp_path))
    store.tokenizers["torch_port_laser2_tok"] = TokenizerCard("torch_port_laser2_tok", "laser2", spm)
    pstore.tokenizers["torch_port_laser2_tok"] = port_store.TokenizerCard(
        "torch_port_laser2_tok", "laser2", spm)
    try:
        rng = np.random.default_rng(6)
        src, mt = rng.normal(size=(2, 1024)).astype(np.float32), rng.normal(size=(2, 1024))
        b = hub.get_blaser_model_hub().load(names[0], device="cpu")
        jb, jbp = jax_hub.load_blaser_model(names[0])
        np.testing.assert_allclose(b(src, mt).numpy(), np.asarray(jb.apply(jbp, src, mt)),
                                   atol=1e-5)
        m = hub.load_mutox_model(names[1], device="cpu")
        jm, jmp = jax_hub.load_mutox_model(names[1])
        np.testing.assert_allclose(m(src).numpy(), np.asarray(jm.apply(jmp, src)), atol=1e-5)
        lz = hub.get_laser2_model_hub().load(names[2], device="cpu")
        jl, jlp = jax_hub.load_laser2_model(names[2])
        np.testing.assert_allclose(lz(SEQS, LENS).numpy(),
                                   np.asarray(jl.apply(jlp, jnp.asarray(SEQS), jnp.asarray(LENS))),
                                   atol=1e-5)
        tok = hub.get_text_tokenizer_hub().load("torch_port_laser2_tok")
        assert tok.create_encoder()("hello cat") == jax_hub.load_tokenizer(
            "torch_port_laser2_tok").create_encoder()("hello cat")
        with pytest.raises(ValueError, match="card"):
            hub.load_mutox_model(names[0], device="cpu")
    finally:
        for name in names:
            del store.models[name], pstore.models[name]
        del store.tokenizers["torch_port_laser2_tok"], pstore.tokenizers["torch_port_laser2_tok"]


def test_heads_run_without_jax():
    """A fresh interpreter in which ``import jax`` fails runs the three heads."""
    script = """
import sys
sys.modules["jax"] = None
import numpy as np
from sonar_tpu_torch.assets import convert
from sonar_tpu_torch.models import blaser, laser2_text, mutox
b = blaser.blaser_archs.get("basic_ref")
x = np.ones((2, 1024), np.float32)
assert convert.blaser_from_numpy(convert.init_blaser_params(b), b, "cpu")(x, x, x).shape == (2, 1)
m = mutox.mutox_archs.get("mutox")
assert convert.mutox_from_numpy(convert.init_mutox_params(m), m, "cpu")(x).shape == (2, 1)
c = laser2_text.laser2_archs.get("toy")
out = convert.laser2_from_numpy(convert.init_laser2_params(c), c, device="cpu")(
    [[5, 6, 1]], [2])
assert out.shape == (1, 48) and np.isfinite(out.numpy()).all()
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
