"""Four gaps between the port and ``sonar_tpu``, each held here on the CPU.

- packaging: every directory of ``sonar_tpu_torch`` that holds Python files
  is a package that ``find_packages`` lists (``sonar_tpu_torch.data`` was
  not), and the package data names the card registry and the native
  sources the port reads at run time;
- ``SonarEncoderDecoderModel.generate(sampler=...)`` samples JAX's tokens
  given JAX's Gumbel noise;
- the flat ``.npz`` native format: written by either package, read by the
  other, the same tree, and the same encoder built from it;
- ``learned_pos=True`` encoders and decoders against JAX's ``init_params``,
  fp32, within 1e-5 of the outputs' scale (one incremental decode step
  included, which reads the table at its ``step`` offset).
"""

import dataclasses
from pathlib import Path
import tomllib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.assets import checkpoint as jckpt  # noqa: E402
from sonar_tpu.data.collate import round_up_pow2  # noqa: E402
from sonar_tpu.generation import sampling as jsampling  # noqa: E402
from sonar_tpu.generation.beam_search import BeamSearchConfig as JaxBeamConfig  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jdec_archs  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_encoder_archs as jenc_archs  # noqa: E402
from sonar_tpu.models.sonar_translation import model as jtranslation  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu_torch.assets import checkpoint as ckpt  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    init_text_decoder_params,
    init_text_encoder_params,
    text_decoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.generation import sampling  # noqa: E402
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.models.sonar_translation import model as translation  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scale_close(got, want, rel=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# -- packaging -----------------------------------------------------------------


def test_find_packages_lists_every_port_directory():
    from setuptools import find_packages

    found = set(find_packages(str(REPO), include=["sonar_tpu*"]))
    assert "sonar_tpu_torch.data" in found
    dirs = {p.parent for p in (REPO / "sonar_tpu_torch").rglob("*.py")
            if "__pycache__" not in p.parts}
    for d in dirs:
        assert (d / "__init__.py").is_file(), f"{d} holds Python files but is no package"
        assert ".".join(d.relative_to(REPO).parts) in found


def test_package_data_names_the_files_the_port_reads():
    """The registry (``assets/store.py``) and the native sources
    (``native/__init__.py``) must ship beside the CUDA sources."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["sonar_tpu_torch"]
    shipped = {p for g in globs for p in (REPO / "sonar_tpu_torch").glob(g)}
    for need in ("assets/cards/registry.yaml", "native/spm.cpp", "native/audio_decode.cpp",
                 "csrc/short_attn.cu", "csrc/hopper.cuh"):
        assert REPO / "sonar_tpu_torch" / need in shipped, need


# -- generate(sampler=...) -----------------------------------------------------------


def _jax_gumbel(seed):
    """JAX's draws of ``generate_sample(seed=seed)``, as the port's noise
    hook takes them (the key folded with the step, the batch padded to a
    power of two)."""
    key = jax.random.PRNGKey(seed)

    def noise(step, shape):
        b, v = shape
        g = jax.random.gumbel(jax.random.fold_in(key, step), (round_up_pow2(b), v), jnp.float32)
        return torch.tensor(np.asarray(g)[:b])

    return noise


@pytest.mark.parametrize("kind", ["top_p", "top_k"])
def test_generate_with_a_sampler_matches_jax(kind, monkeypatch):
    params = _np_tree(JaxDecoder(jdec_archs.get("toy")).init_params(jax.random.PRNGKey(1)))
    jdec = JitTextDecoder(JaxDecoder(jdec_archs.get("toy")), params, quantize=False)
    tdec = TorchTextDecoder(text_decoder_from_numpy(params, sonar_text_decoder_archs.get("toy")),
                            device="cpu")
    generate = tdec.generate_sample
    monkeypatch.setattr(tdec, "generate_sample",
                        lambda *a, seed=0, **k: generate(*a, noise=_jax_gumbel(seed), **k))
    cls, kw = ("TopPSampler", dict(p=0.9)) if kind == "top_p" else ("TopKSampler", dict(k=5))
    emb = np.random.default_rng(3).normal(size=(3, 32)).astype(np.float32) * 2.0
    want = jtranslation.SonarEncoderDecoderModel(jtranslation.DummyEncoderModel(), jdec).generate(
        emb, [3, 7], JaxBeamConfig(max_gen_len=8, min_gen_len=2), getattr(jsampling, cls)(**kw))
    got = translation.SonarEncoderDecoderModel(translation.DummyEncoderModel(), tdec).generate(
        emb, [3, 7], BeamSearchConfig(max_gen_len=8, min_gen_len=2), getattr(sampling, cls)(**kw))
    (tt, ts, tl), (jt, js, jl) = got, want
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=1e-5)


# -- the native .npz format -----------------------------------------------------------


def _flat(tree):
    return {k: np.asarray(v) for k, v in jckpt.flatten_params(tree).items()}


def test_native_format_round_trips_between_the_packages(tmp_path):
    cfg = sonar_text_encoder_archs.get("toy")
    tree = _np_tree(JaxEncoder(jenc_archs.get("toy")).init_params(jax.random.PRNGKey(0)))
    jckpt.save_params(tmp_path / "jax.npz", tree)
    read = ckpt.load_params(tmp_path / "jax.npz")
    want = _flat(tree)
    got = ckpt.flatten_params(read)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    # The port writes its tensors (a model's tree) and JAX reads them back.
    model = text_encoder_from_numpy(tree, cfg)
    ckpt.save_params(tmp_path / "port.npz", model.params.tree())
    back = _flat(jckpt.load_params(tmp_path / "port.npz"))
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])

    seqs = torch.tensor(np.random.default_rng(2).integers(4, 1000, (3, 7)), dtype=torch.int32)
    lens = torch.tensor([7, 4, 1], dtype=torch.int32)
    with torch.inference_mode():
        a = model(seqs, lens).sentence_embeddings
        b = text_encoder_from_numpy(read, cfg)(seqs, lens).sentence_embeddings
    assert torch.equal(a, b)


def test_native_format_keeps_bf16_tensors_as_fp32(tmp_path):
    tree = {"a": {"w": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
            "b": torch.arange(3, dtype=torch.int32)}
    ckpt.save_params(tmp_path / "t.npz", tree)
    back = ckpt.load_params(tmp_path / "t.npz")
    assert back["a"]["w"].dtype == np.float32 and back["b"].dtype == np.int32
    np.testing.assert_array_equal(back["a"]["w"], [1.5, -2.25])
    np.testing.assert_array_equal(back["b"], [0, 1, 2])


# -- learned positions ----------------------------------------------------------------------


def _learned(archs):
    return dataclasses.replace(archs.get("toy"), learned_pos=True)


def test_learned_pos_encoder_matches_jax():
    jcfg, tcfg = _learned(jenc_archs), _learned(sonar_text_encoder_archs)
    jmodel = JaxEncoder(jcfg)
    params = _np_tree(jmodel.init_params(jax.random.PRNGKey(4)))
    assert params["encoder_frontend"]["pos"]["weight"].shape == (jmodel.max_seq_len, 32)
    rng = np.random.default_rng(5)
    seqs = rng.integers(4, 1000, (3, 9)).astype(np.int32)
    lens = np.array([9, 6, 2], np.int32)
    want = jmodel.apply(params, jnp.asarray(seqs), jnp.asarray(lens)).sentence_embeddings
    model = text_encoder_from_numpy(params, tcfg)
    assert model.max_source_len == jmodel.max_source_len
    with torch.inference_mode():
        got = model(torch.tensor(seqs), torch.tensor(lens)).sentence_embeddings
    _scale_close(got, want)
    with pytest.raises(NotImplementedError, match="sinusoidal"):
        model.apply_packed(model.params.tree(), torch.tensor(seqs), torch.ones_like(
            torch.tensor(seqs)), torch.zeros_like(torch.tensor(seqs)), 1)
    # The port's numpy initialiser draws the table too.
    fresh = init_text_encoder_params(tcfg, seed=0)
    assert fresh["encoder_frontend"]["pos"]["weight"].shape == (model.max_seq_len, 32)


def test_learned_pos_decoder_matches_jax():
    """Teacher-forced logits, then the cache path: a prefix of 3 tokens fed
    one step at a time, each step's logits against JAX's."""
    jcfg, tcfg = _learned(jdec_archs), _learned(sonar_text_decoder_archs)
    jmodel = JaxDecoder(jcfg)
    params = _np_tree(jmodel.init_params(jax.random.PRNGKey(6)))
    rng = np.random.default_rng(7)
    seqs = rng.integers(4, 1000, (2, 5)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    memory = rng.normal(size=(2, 1, 32)).astype(np.float32)
    want = jmodel.forward(params, jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(memory))
    model = text_decoder_from_numpy(params, tcfg)
    assert model.max_target_len == jmodel.max_target_len == tcfg.max_seq_len
    with torch.inference_mode():
        got = model(torch.tensor(seqs), torch.tensor(lens), torch.tensor(memory))
        _scale_close(got, want)
        jcache = jmodel.init_cache(params, jnp.asarray(memory), 8)
        tcache = model.init_cache(torch.tensor(memory), 8)
        for t in range(3):
            want_t, jcache = jmodel.step(params, jnp.asarray(seqs[:, t]), jcache)
            got_t, tcache = model.step(torch.tensor(seqs[:, t]), tcache)
            _scale_close(got_t, want_t)
    fresh = init_text_decoder_params(tcfg, seed=0)
    assert fresh["decoder_frontend"]["pos"]["weight"].shape == (tcfg.max_seq_len, 32)
