"""The port's sampling generation against ``sonar_tpu``'s on small decoders.

Two fp32 configs, as in ``test_torch_port_decode.py``: ``toy`` and a D 128
decoder of 2 heads of 64 with a 3000-row vocabulary (wide enough for the
blocked exact top-k). Both packages sample ``argmax(filtered + G)``; here
the port is given JAX's own Gumbel draws ``G`` through its ``noise`` hook (the
key ``fold_in(PRNGKey(seed), step)`` over the power-of-two-padded batch, as
``JitTextDecoder.generate_sample`` draws it, sliced to the real rows), so
the sampled tokens and lengths must be identical and the scores agree to
1e-5 (fp32 log-probabilities summed in another order).
"""

import dataclasses
from pathlib import Path
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from helpers import build_toy_nllb, build_toy_spm_proto  # noqa: E402

from sonar_tpu.data.collate import round_up_pow2  # noqa: E402
from sonar_tpu.generation import sampling as jsampling  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jax_dec_archs  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu_torch.assets.convert import text_decoder_from_numpy  # noqa: E402
from sonar_tpu_torch.generation import sampling  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402


def _wide(archs):
    toy = archs.get("toy")
    return dataclasses.replace(
        toy, model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
        ffn_inner_dim=256, vocab_info=dataclasses.replace(toy.vocab_info, size=3000))


_RUNTIMES = {}
EOS_SCALE = {"toy": 1.4, "wide": 0.45}


def _runtimes(name):
    """(JAX runtime, port runtime on the CPU) of one fp32 config, the same
    weights. Random weights almost never sample EOS, so its (tied) embedding
    row is set along the decoder's mean output direction, scaled so that
    some rows stop early and others run to the length limit."""
    if name not in _RUNTIMES:
        jcfg, tcfg = ((jax_dec_archs.get("toy"), sonar_text_decoder_archs.get("toy"))
                      if name == "toy" else (_wide(jax_dec_archs), _wide(sonar_text_decoder_archs)))
        params = jax.tree_util.tree_map(np.array, JaxDecoder(jcfg).init_params(
            jax.random.PRNGKey(1)))
        d = tcfg.model_dim
        seqs = np.full((6, 5), 7, np.int32)
        seqs[:, 0] = 3
        memory = np.random.default_rng(6).normal(size=(6, 1, d)).astype(np.float32) * 2.0
        with torch.inference_mode():
            h = text_decoder_from_numpy(params, tcfg).decode(
                torch.tensor(seqs), None, torch.tensor(memory)).reshape(-1, d).mean(0).numpy()
        params["decoder_frontend"]["embed"]["weight"][3] = (
            h / np.linalg.norm(h) * EOS_SCALE[name] * np.sqrt(d) / 4)
        _RUNTIMES[name] = (JitTextDecoder(JaxDecoder(jcfg), params, quantize=False),
                           TorchTextDecoder(text_decoder_from_numpy(params, tcfg), device="cpu"))
    return _RUNTIMES[name]


def jax_gumbel(seed):
    """The noise hook giving JAX's draws of ``generate_sample(seed=seed)``."""
    key = jax.random.PRNGKey(seed)

    def noise(step, shape):
        b, v = shape
        g = jax.random.gumbel(jax.random.fold_in(key, step), (round_up_pow2(b), v), jnp.float32)
        return torch.tensor(np.asarray(g)[:b])

    return noise


def test_categorical_is_argmax_of_logits_plus_gumbel():
    """What the hook relies on: ``jax.random.categorical`` is the argmax of
    the logits plus ``jax.random.gumbel`` of the same key and shape."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    logits = jnp.asarray(np.random.default_rng(0).normal(size=(4, 300)), jnp.float32)
    want = jax.random.categorical(key, logits, axis=-1)
    got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape, jnp.float32), axis=-1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


SAMPLERS = [
    ("top_p", dict(p=0.9), {}),
    ("top_p_candidates", dict(p=0.8, max_candidates=5), {}),
    ("top_k", dict(k=4), {}),
    ("top_p_temperature", dict(p=0.9, temperature=0.7), {}),
    ("top_k_min_len", dict(k=10), dict(min_gen_len=3)),
]


@pytest.mark.parametrize("case", SAMPLERS, ids=lambda c: c[0])
@pytest.mark.parametrize("name", ["toy", "wide"])
def test_generate_sample_matches_jax(name, case):
    label, kwargs, gen = case
    jrun, trun = _runtimes(name)
    cls = "TopKSampler" if "k" in kwargs else "TopPSampler"
    jsampler, tsampler = getattr(jsampling, cls)(**kwargs), getattr(sampling, cls)(**kwargs)
    memory = np.random.default_rng(6).normal(size=(3, 1, trun.model.config.model_dim))
    memory = memory.astype(np.float32) * 2.0
    prefix, seed = [3, 7], 11
    jt, js, jl = jrun.generate_sample(memory, prefix, jsampler, max_gen_len=9, seed=seed, **gen)
    tt, ts, tl = trun.generate_sample(memory, prefix, tsampler, max_gen_len=9,
                                      noise=jax_gumbel(seed), **gen)
    assert tt.shape == jt.shape == (3, 10) and tt.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)  # padding after EOS included
    np.testing.assert_allclose(ts, js, atol=1e-5)
    if gen.get("min_gen_len"):
        assert all(3 not in tt[r, :2].tolist() for r in range(3))
    if label == "top_p":  # a row stopped at its own EOS, another at the limit
        assert tl.min() < 10 and tl.max() == 10


def test_generate_sample_with_its_own_generator():
    """Without a hook the port draws JAX's noise from the seed itself
    (``ops.cuda.gumbel_max``; ``test_torch_port_sample_loop.py`` holds it
    to JAX's): a seed repeats its samples, another seed gives others, and
    every row ends in EOS within the length limit."""
    _, trun = _runtimes("wide")
    memory = np.random.default_rng(7).normal(size=(4, 1, 128)).astype(np.float32)
    sampler = sampling.TopPSampler(p=0.95)
    a = trun.generate_sample(memory, [3, 7], sampler, max_gen_len=6, seed=1)
    b = trun.generate_sample(memory, [3, 7], sampler, max_gen_len=6, seed=1)
    c = trun.generate_sample(memory, [3, 7], sampler, max_gen_len=6, seed=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    tokens, _, lens = a
    assert all(tokens[r, lens[r] - 1] == 3 for r in range(4)) and lens.max() <= 7
    with pytest.raises(ValueError, match="no room"):
        trun.generate_sample(memory, [3] * 600, sampler, max_gen_len=4)


def test_filters_match_jax():
    """``filter_logprobs`` of both samplers on log-probabilities with ties."""
    rng = np.random.default_rng(8)
    lp = np.log(rng.dirichlet(np.ones(700) * 0.3, size=5)).astype(np.float32)
    lp[1, ::50] = lp[1].max()
    for jax_s, port_s in ((jsampling.TopPSampler(0.7), sampling.TopPSampler(0.7)),
                          (jsampling.TopPSampler(0.5, max_candidates=40),
                           sampling.TopPSampler(0.5, max_candidates=40)),
                          (jsampling.TopKSampler(7), sampling.TopKSampler(7))):
        got = port_s.filter_logprobs(torch.tensor(lp)).numpy()
        want = np.asarray(jax_s.filter_logprobs(jnp.asarray(lp)))
        np.testing.assert_array_equal(got > -1e29, want > -1e29)
        np.testing.assert_array_equal(got, want)


def test_embedding_to_text_sampling_pipeline_matches_jax(tmp_path, monkeypatch):
    """``EmbeddingToTextModelPipeline.predict(sampler=...)`` gives the JAX
    pipeline's strings (batches of 3 and 1, JAX's noise through the hook),
    and the converter with a sampler takes the sampling path."""
    from sonar_tpu.inference_pipelines.text import EmbeddingToTextModelPipeline as JaxPipe
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    path = tmp_path / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    tok = NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")
    jcfg = dataclasses.replace(jax_dec_archs.get("toy"), vocab_info=dataclasses.replace(
        jax_dec_archs.get("toy").vocab_info, size=tok.vocab_info.size))
    tcfg = dataclasses.replace(sonar_text_decoder_archs.get("toy"), vocab_info=dataclasses.replace(
        sonar_text_decoder_archs.get("toy").vocab_info, size=tok.vocab_info.size))
    params = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init_params(
        jax.random.PRNGKey(4)))
    port = EmbeddingToTextModelPipeline(text_decoder_from_numpy(params, tcfg), tok, device="cpu")
    generate = port.decoder.generate_sample
    monkeypatch.setattr(port.decoder, "generate_sample",
                        lambda *a, seed=0, **k: generate(*a, noise=jax_gumbel(seed), **k))
    emb = np.random.default_rng(9).normal(size=(4, 32)).astype(np.float32) * 3.0
    kw = dict(target_lang="fra_Latn", batch_size=3, max_gen_len=10)
    for jax_s, port_s in ((jsampling.TopPSampler(0.9), sampling.TopPSampler(0.9)),
                          (jsampling.TopKSampler(5), sampling.TopKSampler(5))):
        got = port.predict(emb, sampler=port_s, **kw)
        want = JaxPipe((JaxDecoder(jcfg), params), build_toy_nllb(tmp_path),
                       quantize=False).predict(emb, sampler=jax_s, **kw)
        assert len(got) == 4 and got == want
