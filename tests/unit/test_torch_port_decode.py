"""The port's embedding -> text slice against ``sonar_tpu``'s on small decoders.

Two configs: ``toy`` (D 32, 4 heads of 8) and a D 128 decoder of 2 heads of
64 (the kernels' head dim) with a 3000-row vocabulary, wide enough for the
blocked exact top-k. Weights and inputs come from seeds and go to both
packages. Tolerances: fp32 logits and states agree to atol 1e-4 (two
frameworks summing the same products in another order through a few
layers); beam search gives identical token ids and lengths and scores to
1e-5; the pipelines identical strings.
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

from sonar_tpu.assets import checkpoint as ckpt  # noqa: E402
from sonar_tpu.generation import beam_search as jbs  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jax_dec_archs  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_encoder_archs as jax_enc_archs  # noqa: E402
from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.ops.topk import exact_top_k_wide as jax_top_k_wide  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    init_text_decoder_params,
    load_text_decoder_checkpoint,
    text_decoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.generation import beam_search as tbs  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.generation.text_converter import EmbeddingToTextConverter  # noqa: E402
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.nn import transformer as ttr  # noqa: E402
from sonar_tpu_torch.ops.topk import exact_top_k_wide  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402

TEXTS = ["hello world", "my name is paul", "i work as a teacher", "bonjour", "the cat sat",
         "je suis"]


def _wide(archs):
    toy = archs.get("toy")
    return dataclasses.replace(
        toy, model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
        ffn_inner_dim=256, vocab_info=dataclasses.replace(toy.vocab_info, size=3000))


def _cfgs(name):
    if name == "toy":
        return jax_dec_archs.get("toy"), sonar_text_decoder_archs.get("toy")
    return _wide(jax_dec_archs), _wide(sonar_text_decoder_archs)


_PARAMS = {}


def _decoders(name, dtype="float32"):
    """(JAX decoder, its params, port decoder on the CPU) of one config."""
    jcfg, tcfg = _cfgs(name)
    if name not in _PARAMS:
        _PARAMS[name] = jax.tree_util.tree_map(
            np.asarray, JaxDecoder(jcfg).init_params(jax.random.PRNGKey(1)))
    params = _PARAMS[name]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    return JaxDecoder(jcfg, dtype=jdt), jparams, text_decoder_from_numpy(params, tcfg, tdt)


def _seqs(rng, b, s, vocab, lens):
    seqs = rng.integers(4, vocab, size=(b, s)).astype(np.int32)
    seqs[:, 0] = 3
    return seqs, np.asarray(lens, np.int32)


# -- modules --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_forward_matches_jax(name):
    """Teacher-forced ``forward`` (decode + tied projection) on a length-1
    and a length-3 masked memory."""
    jdec, jparams, tdec = _decoders(name)
    rng = np.random.default_rng(0)
    d = tdec.config.model_dim
    seqs, lens = _seqs(rng, 3, 9, 200, [9, 5, 1])
    for mem_len, mem_lens in ((1, None), (3, np.asarray([3, 2, 1], np.int32))):
        memory = rng.normal(size=(3, mem_len, d)).astype(np.float32)
        with torch.inference_mode():
            got = tdec(torch.tensor(seqs), torch.tensor(lens), torch.tensor(memory),
                       None if mem_lens is None else torch.tensor(mem_lens))
        want = jdec.forward(jparams, jnp.asarray(seqs), jnp.asarray(lens), jnp.asarray(memory),
                            None if mem_lens is None else jnp.asarray(mem_lens))
        assert got.dtype == torch.float32 and got.shape == (3, 9, tdec.config.vocab_info.size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_forward_bf16_keeps_fp32_logits():
    """bf16 decoder: fp32 logits from the tied projection; row cosine with
    the JAX bf16 decoder >= 0.999 (bf16 rounds at other places)."""
    jdec, jparams, tdec = _decoders("wide", "bfloat16")
    rng = np.random.default_rng(1)
    seqs, lens = _seqs(rng, 2, 7, 3000, [7, 4])
    memory = rng.normal(size=(2, 1, 128)).astype(np.float32)
    with torch.inference_mode():
        got = tdec(torch.tensor(seqs), torch.tensor(lens), torch.tensor(memory)).numpy()
    want = np.asarray(jdec.forward(jparams, jnp.asarray(seqs), jnp.asarray(lens),
                                   jnp.asarray(memory)), np.float32)
    assert got.dtype == np.float32
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1) * np.linalg.norm(w, axis=1))
    assert cos.min() >= 0.999


@pytest.mark.parametrize("mem_len", [1, 3])
@pytest.mark.parametrize("name", ["toy", "wide"])
def test_cache_and_plain_steps_match_jax(name, mem_len):
    """``init_decoder_cache`` (the length-1 ``cross_out`` collapse, or
    projected cross K/V) and five plain ``step`` calls: logits and the
    written cache agree with the JAX decoder."""
    jdec, jparams, tdec = _decoders(name)
    rng = np.random.default_rng(2)
    d, b, s_max = tdec.config.model_dim, 2, 8
    memory = rng.normal(size=(b, mem_len, d)).astype(np.float32)
    jcache = jdec.init_cache(jparams, jnp.asarray(memory), s_max)
    with torch.inference_mode():
        tcache = tdec.init_cache(torch.tensor(memory), s_max)
    if mem_len == 1:
        assert tcache.cross_k.shape[3] == 0
        np.testing.assert_allclose(tcache.cross_out.numpy(), np.asarray(jcache.cross_out),
                                   atol=1e-5)
    else:
        assert tcache.cross_out is None
        np.testing.assert_allclose(tcache.cross_k.numpy(), np.asarray(jcache.cross_k), atol=1e-5)
        np.testing.assert_allclose(tcache.cross_v.numpy(), np.asarray(jcache.cross_v), atol=1e-5)
    for _ in range(5):
        toks = rng.integers(4, 200, size=(b,)).astype(np.int32)
        with torch.inference_mode():
            got, tcache = tdec.step(torch.tensor(toks), tcache)
        want, jcache = jdec.step(jparams, jnp.asarray(toks), jcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert tcache.index == int(jcache.index) == 5
    np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(jcache.self_k), atol=1e-4)
    np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(jcache.self_v), atol=1e-4)


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_beam_steps_match_jax(name):
    """``decoder_step`` in beam mode: the [L, B, H, K, S, Dh] cache read
    through a random ancestry table; logits and cache agree."""
    jdec, jparams, tdec = _decoders(name)
    rng = np.random.default_rng(3)
    d, b, k, s_max = tdec.config.model_dim, 2, 3, 7
    memory = np.repeat(rng.normal(size=(b, 1, d)).astype(np.float32), k, axis=0)
    jcache = jdec.init_cache(jparams, jnp.asarray(memory), s_max, beam_size=k)
    with torch.inference_mode():
        tcache = tdec.init_cache(torch.tensor(memory), s_max, beam_size=k)
    assert tuple(tcache.self_k.shape) == tuple(jcache.self_k.shape)
    for step in range(5):
        toks = rng.integers(4, 200, size=(b * k,)).astype(np.int32)
        anc = rng.integers(0, k, size=(b * k, s_max)).astype(np.int32)
        anc[:, step] = np.tile(np.arange(k), b)  # each row writes its own slot
        with torch.inference_mode():
            got, tcache = tdec.step(torch.tensor(toks), tcache, ancestry=torch.tensor(anc),
                                    beam_size=k)
        want, jcache = jdec.step(jparams, jnp.asarray(toks), jcache, ancestry=jnp.asarray(anc),
                                 beam_size=k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(jcache.self_v), atol=1e-4)


def test_decoder_step_matches_jax_directly():
    """``nn.transformer.decoder_step`` on the stacked layers (no frontend),
    plain mode, against the JAX function with a masked 2-row memory."""
    jdec, jparams, tdec = _decoders("toy")
    rng = np.random.default_rng(4)
    b, d = 2, 32
    memory = rng.normal(size=(b, 2, d)).astype(np.float32)
    mem_bias = np.where(np.asarray([[True, True], [True, False]]), 0.0,
                        np.finfo(np.float32).min).astype(np.float32)[:, None, None, :]
    jcache = jtr.init_decoder_cache(jparams["decoder"]["layers"], jnp.asarray(memory), 4, 6, b,
                                    d, jnp.float32)
    tlayers = tdec.params.tree()["decoder"]["layers"]
    with torch.inference_mode():
        tcache = ttr.init_decoder_cache(tlayers, torch.tensor(memory), 4, 6, b, d, torch.float32)
        for _ in range(3):
            x = rng.normal(size=(b, 1, d)).astype(np.float32)
            got, tcache = ttr.decoder_step(tlayers, torch.tensor(x), tcache,
                                           torch.tensor(mem_bias), 4, "relu")
            want, jcache = jtr.decoder_step(jparams["decoder"]["layers"], jnp.asarray(x), jcache,
                                            jnp.asarray(mem_bias), 4, "relu")
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_exact_top_k_wide_with_forced_ties():
    """Values, indices and the lower-index-first tie order of ``lax.top_k``,
    on rows full of repeated values, through the blocked path (3000 and
    2100 columns: padded last block) and the plain one (700)."""
    rng = np.random.default_rng(5)
    for width in (3000, 2100, 700):
        x = rng.integers(0, 7, size=(6, width)).astype(np.float32)  # heavy ties
        x[1] = 3.0                                                 # one value only
        x[2, ::97] = 9.0                                           # ties across blocks
        for k in (1, 12):
            got_v, got_i = exact_top_k_wide(torch.tensor(x), k)
            want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
            wide_v, wide_i = jax_top_k_wide(jnp.asarray(x), k)
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(wide_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(wide_v))


# -- beam search ----------------------------------------------------------------------


CONFIGS = [
    dict(beam_size=3, max_gen_len=8, len_penalty=1.0),
    dict(beam_size=3, max_gen_len=8, len_penalty=0.0),
    dict(beam_size=2, max_gen_len=9, len_penalty=-0.5),
    dict(beam_size=3, max_gen_len=7, unk_penalty=2.5),
    dict(beam_size=4, max_gen_len=8, min_gen_len=4),
    dict(beam_size=3, max_gen_len=6, normalize_scores=False),
]

_JAX_RUNTIMES = {}


def _runtimes(name):
    jdec, jparams, tdec = _decoders(name)
    if name not in _JAX_RUNTIMES:
        _JAX_RUNTIMES[name] = JitTextDecoder(jdec, jparams, quantize=False)
    return _JAX_RUNTIMES[name], TorchTextDecoder(tdec, device="cpu")


def _oracle_fn(tdec, memory_row):
    """Teacher-forced next-token logprobs of the port's decoder."""
    def fn(seqs):
        n, s = len(seqs), max(len(x) for x in seqs)
        arr = np.ones((n, s), np.int64)
        for i, x in enumerate(seqs):
            arr[i, : len(x)] = x
        lens = torch.tensor([len(x) for x in seqs])
        with torch.inference_mode():
            logits = tdec(torch.tensor(arr), lens,
                          torch.tensor(np.repeat(memory_row, n, axis=0)))
        last = logits[torch.arange(n), lens - 1]
        return torch.log_softmax(last.double(), dim=-1).numpy()
    return fn


@pytest.mark.parametrize("kwargs", CONFIGS, ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
@pytest.mark.parametrize("name", ["toy", "wide"])
def test_beam_search_matches_jax(name, kwargs):
    """``beam_search_lax`` of the port against the JAX ``beam_search_lax``
    (through both runtimes, a batch of 3 padded to 4): every hypothesis's
    token ids and length identical, scores to 1e-5; the best against the
    JAX oracle too."""
    jrun, trun = _runtimes(name)
    config = jbs.BeamSearchConfig(**kwargs)
    tconfig = tbs.BeamSearchConfig(**kwargs)
    rng = np.random.default_rng(6)
    d = trun.model.config.model_dim
    memory = rng.normal(size=(3, 1, d)).astype(np.float32) * 2.0
    prefix = [3, 7]
    jt, js, jl = jrun.generate_beam(memory, prefix, config)
    tt, ts, tl = trun.generate_beam(memory, prefix, tconfig)
    np.testing.assert_array_equal(tl, jl)
    for r in range(3):
        for k in range(config.beam_size):
            assert tt[r, k, : tl[r, k]].tolist() == jt[r, k, : jl[r, k]].tolist()
    np.testing.assert_allclose(ts, js, atol=1e-5)
    unk = trun.vocab_info.unk_idx
    for r in range(3):
        want_toks, want_score = jbs.beam_search_oracle(
            _oracle_fn(trun.model, memory[r:r + 1]), prefix, 3, config, unk_idx=unk)
        assert tt[r, 0, : tl[r, 0]].tolist() == want_toks
        np.testing.assert_allclose(ts[r, 0], want_score, atol=1e-5)


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_approx_topk_matches_jax(name):
    """``approx_topk=True`` in both packages: JAX's ``lax.approx_max_k`` is
    exact off a TPU and the port's shortlist is the exact blocked top-k, so
    the hypotheses are identical token for token (scores to 1e-5, as in
    test_beam_search_matches_jax)."""
    jrun, trun = _runtimes(name)
    kwargs = dict(beam_size=3, max_gen_len=8, approx_topk=True)
    config, tconfig = jbs.BeamSearchConfig(**kwargs), tbs.BeamSearchConfig(**kwargs)
    memory = np.random.default_rng(11).normal(
        size=(3, 1, trun.model.config.model_dim)).astype(np.float32) * 2.0
    jt, js, jl = jrun.generate_beam(memory, [3, 7], config)
    tt, ts, tl = trun.generate_beam(memory, [3, 7], tconfig)
    np.testing.assert_array_equal(tl, jl)
    for r in range(3):
        for k in range(config.beam_size):
            assert tt[r, k, : tl[r, k]].tolist() == jt[r, k, : jl[r, k]].tolist()
    np.testing.assert_allclose(ts, js, atol=1e-5)


def test_oracle_is_the_jax_oracle():
    """The port's ``beam_search_oracle`` and the JAX one on one callback."""
    _, trun = _runtimes("toy")
    memory = np.random.default_rng(7).normal(size=(1, 1, 32)).astype(np.float32)
    fn = _oracle_fn(trun.model, memory)
    for kwargs in CONFIGS:
        got = tbs.beam_search_oracle(fn, [3, 5], 3, tbs.BeamSearchConfig(**kwargs), unk_idx=1)
        want = jbs.beam_search_oracle(fn, [3, 5], 3, jbs.BeamSearchConfig(**kwargs), unk_idx=1)
        assert got[0] == want[0] and got[1] == pytest.approx(want[1], abs=1e-12)


def test_negative_penalty_bound_on_a_crafted_table():
    """The early-exit bound for a negative penalty, on the JAX tests'
    crafted table where a max-length bound would drop the winner."""
    table = np.asarray([[-2.5, -0.1, -4.34, -30.0], [-1.5, -0.5, -1.77, -30.0],
                        [-0.0202, -4.5, -4.72, -30.0]], np.float32)
    config = tbs.BeamSearchConfig(beam_size=2, max_gen_len=8, len_penalty=-1.0)
    calls = []

    def step_fn(tokens, cache, ancestry):
        calls.append(cache)
        row = torch.tensor(table[min(cache, len(table) - 1)])
        return row.expand(2, 4).clone(), cache + 1

    tokens, scores, lens = tbs.beam_search_lax(step_fn, 0, torch.tensor([[0]]), 0, 4, config,
                                               pad_idx=3)
    assert tokens[0, 0, : lens[0, 0]].tolist() == [1, 1, 0]
    np.testing.assert_allclose(float(scores[0, 0]), -1.8606, atol=2e-3)


def test_runtime_options():
    _, trun = _runtimes("toy")
    _, _, tdec = _decoders("toy")
    # quantize=True: every projection of the layers int8 (stored column-major
    # with per-output-channel scales), the tied embedding in floating point.
    qdec = TorchTextDecoder(tdec, quantize=True, device="cpu").model.params.tree()
    layers = qdec["decoder"]["layers"]
    for blk, names in (("self_attn", ("q_proj", "k_proj", "v_proj", "output_proj")),
                       ("encoder_decoder_attn", ("q_proj", "k_proj", "v_proj", "output_proj")),
                       ("ffn", ("inner_proj", "output_proj"))):
        for n in names:
            assert layers[blk][n]["kernel_q"].dtype == torch.int8 and "kernel" not in layers[blk][n]
    assert qdec["decoder_frontend"]["embed"]["weight"].dtype == torch.float32
    assert "kernel" in trun.model.params.tree()["decoder"]["layers"]["ffn"]["inner_proj"]
    with pytest.raises(ValueError, match="no room"):
        trun.generate_beam(np.zeros((1, 1, 32), np.float32), [3] * 600,
                           tbs.BeamSearchConfig())
    capped = trun._cap_gen_len(tbs.BeamSearchConfig(max_gen_len=600), 2)
    assert capped.max_gen_len == trun.max_target_len - 2 == 508
    with pytest.raises(TypeError):
        tbs.BeamSearchConfig.from_kwargs(512, beam_sz=3)
    cfg = tbs.BeamSearchConfig.from_kwargs(510, beam_size=2, max_seq_len=20)
    assert (cfg.beam_size, cfg.max_gen_len, cfg.approx_topk) == (2, 20, False)
    # ``approx_topk`` is accepted as the JAX package accepts it (the selection
    # stays exact: test_approx_topk_matches_jax).
    assert tbs.BeamSearchConfig.from_kwargs(512, approx_topk=True).approx_topk
    steps = trun.decode_steps
    assert trun.warmup(tbs.BeamSearchConfig(beam_size=2, max_gen_len=3), batch_sizes=(2,)) == 1
    assert trun.decode_steps > steps


# -- int8 decode ----------------------------------------------------------------------


_INT8_RUNTIMES = {}


def _int8_runtimes(name):
    """(JAX int8 runtime, JAX fp32 runtime, port int8 runtime on the CPU)."""
    if name not in _INT8_RUNTIMES:
        jdec, jparams, tdec = _decoders(name)
        _INT8_RUNTIMES[name] = (JitTextDecoder(jdec, jparams, quantize=True), _runtimes(name)[0],
                                TorchTextDecoder(tdec, quantize=True, device="cpu"))
    return _INT8_RUNTIMES[name]


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_int8_score_matches_jax(name):
    """Teacher-forced int8 logits (every projection through ``linear``'s
    int8 path) within 1e-3 of their scale of the JAX int8 decoder's, on a
    length-1 memory (the ``cross_out`` collapse is not taken by ``score``)
    and a masked-free length-3 one; and visibly apart from fp32."""
    jq, jfp, tq = _int8_runtimes(name)
    rng = np.random.default_rng(10)
    d = tq.model.config.model_dim
    seqs, lens = _seqs(rng, 3, 9, 200, [9, 5, 2])
    for mem_len in (1, 3):
        memory = rng.normal(size=(3, mem_len, d)).astype(np.float32)
        got, want = tq.score(seqs, lens, memory), jq.score(seqs, lens, memory)
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-3 * scale
        assert np.abs(jfp.score(seqs, lens, memory) - want).max() > 1e-3 * scale


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_int8_beam_search_matches_jax(name):
    """Beam search with int8 weights (the incremental step: the cache's
    ``cross_out`` collapse, the self-attention K/V and the FFN all through
    int8 projections): scores within 1e-3 of JAX's int8 decode, and the best
    hypothesis token-identical wherever JAX's fp32 margin between its two
    best clears the int8 noise floor (as ``test_quantized_pipeline.py``)."""
    jq, jfp, tq = _int8_runtimes(name)
    memory = np.random.default_rng(11).normal(size=(8, 1, tq.model.config.model_dim))
    memory = memory.astype(np.float32) * 2.0
    config, tconfig = jbs.BeamSearchConfig(beam_size=3, max_gen_len=8), tbs.BeamSearchConfig(
        beam_size=3, max_gen_len=8)
    jt, js, jl = jq.generate_beam(memory, [3, 7], config)
    tt, ts, tl = tq.generate_beam(memory, [3, 7], tconfig)
    _, fs, _ = jfp.generate_beam(memory, [3, 7], config)
    np.testing.assert_allclose(ts[:, 0], js[:, 0], atol=1e-3)
    gated = [r for r in range(8) if fs[r, 0] - fs[r, 1] > 0.02]
    assert gated
    for r in gated:
        assert tl[r, 0] == jl[r, 0]
        assert tt[r, 0, : tl[r, 0]].tolist() == jt[r, 0, : jl[r, 0]].tolist()


def test_int8_sampling_matches_jax():
    """Sampling with int8 weights, JAX's noise through the hook: the same
    tokens as the JAX int8 decoder."""
    from sonar_tpu.generation.sampling import TopKSampler as JaxTopK
    from sonar_tpu_torch.generation.sampling import TopKSampler

    jq, _, tq = _int8_runtimes("wide")
    memory = np.random.default_rng(12).normal(size=(3, 1, 128)).astype(np.float32) * 2.0
    key = jax.random.PRNGKey(2)

    def noise(step, shape):
        g = jax.random.gumbel(jax.random.fold_in(key, step), (4, shape[1]), jnp.float32)
        return torch.tensor(np.asarray(g)[: shape[0]])

    jt, js, jl = jq.generate_sample(memory, [3, 7], JaxTopK(20), max_gen_len=6, seed=2)
    tt, ts, tl = tq.generate_sample(memory, [3, 7], TopKSampler(20), max_gen_len=6, noise=noise)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(ts, js, atol=1e-3)


# -- pipelines ------------------------------------------------------------------------


def _port_tokenizer(tmp_path):
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    path = tmp_path / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    return NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")


def _pipeline_decoders(tokenizer):
    """Toy decoders over the toy tokenizer's vocabulary, fp32."""
    vocab = tokenizer.vocab_info
    jcfg = dataclasses.replace(jax_dec_archs.get("toy"), vocab_info=dataclasses.replace(
        jax_dec_archs.get("toy").vocab_info, size=vocab.size))
    tcfg = dataclasses.replace(sonar_text_decoder_archs.get("toy"), vocab_info=dataclasses.replace(
        sonar_text_decoder_archs.get("toy").vocab_info, size=vocab.size))
    params = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init_params(
        jax.random.PRNGKey(4)))
    return (JaxDecoder(jcfg), params), text_decoder_from_numpy(params, tcfg)


def test_embedding_to_text_pipeline_matches_jax(tmp_path):
    from sonar_tpu.inference_pipelines.text import EmbeddingToTextModelPipeline as JaxPipe
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline

    tok = _port_tokenizer(tmp_path)
    jdec, tdec = _pipeline_decoders(tok)
    emb = np.random.default_rng(8).normal(size=(7, 32)).astype(np.float32) * 3.0
    kw = dict(target_lang="fra_Latn", batch_size=3, beam_size=3, max_gen_len=10)
    got = EmbeddingToTextModelPipeline(tdec, tok, device="cpu").predict(emb, **kw)
    want = JaxPipe(jdec, build_toy_nllb(tmp_path), quantize=False).predict(emb, **kw)
    assert len(got) == 7 and got == want
    assert any(got)
    # A converter given a sampler samples: top-1 sampling is greedy decoding,
    # the same in both packages whatever their noise.
    from sonar_tpu.generation.sampling import TopKSampler as JaxTopK
    from sonar_tpu.generation.text_converter import EmbeddingToTextConverter as JaxConverter
    from sonar_tpu_torch.generation.sampling import TopKSampler

    cfg = dict(beam_size=1, max_gen_len=10)
    got = EmbeddingToTextConverter(TorchTextDecoder(tdec, device="cpu"), tok, "fra_Latn",
                                   tbs.BeamSearchConfig(**cfg), sampler=TopKSampler(1),
                                   seed=3).batch_convert(emb)
    want = JaxConverter(JitTextDecoder(*jdec, quantize=False), build_toy_nllb(tmp_path),
                        "fra_Latn", jbs.BeamSearchConfig(**cfg), sampler=JaxTopK(1),
                        seed=5).batch_convert(emb)
    assert got == want


def test_text_to_text_pipeline_matches_jax(tmp_path):
    from sonar_tpu.inference_pipelines.text import JitTextEncoder
    from sonar_tpu.inference_pipelines.text import TextToTextModelPipeline as JaxPipe
    from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline

    tok = _port_tokenizer(tmp_path)
    jdec, tdec = _pipeline_decoders(tok)
    ecfg = jax_enc_archs.get("toy")
    eparams = jax.tree_util.tree_map(np.asarray, JaxEncoder(ecfg).init_params(
        jax.random.PRNGKey(0)))
    tenc = text_encoder_from_numpy(eparams, sonar_text_encoder_archs.get("toy"))
    kw = dict(source_lang="eng_Latn", target_lang="fra_Latn", batch_size=4, beam_size=2,
              max_gen_len=8)
    port = TextToTextModelPipeline(tenc, tdec, tok, device="cpu")
    got = port.predict(TEXTS, **kw)
    want = JaxPipe(JitTextEncoder(JaxEncoder(ecfg), eparams), jdec, build_toy_nllb(tmp_path),
                   quantize=False).predict(TEXTS, **kw)
    assert len(got) == len(TEXTS) and got == want
    assert port.warmup(batch_size=4, target_lang="fra_Latn", beam_size=2, max_gen_len=3) > 1


# -- weights --------------------------------------------------------------------------


def _decoder_state(params, n_layers):
    """The pytree written back as a fairseq2 decoder state dict."""
    state = {"decoder_frontend.embed.weight": params["decoder_frontend"]["embed"]["weight"]}
    for k in ("weight", "bias"):
        state[f"decoder.layer_norm.{k}"] = params["decoder"]["layer_norm"][k]
    layers = params["decoder"]["layers"]
    for i in range(n_layers):
        p = f"decoder.layers.{i}"
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


def test_weight_bridge_and_hub(tmp_path):
    """The numpy init has the JAX layout; a fairseq2 checkpoint loads into
    both packages (directly and through a model card) with the same tree
    and the same teacher-forced logits."""
    from sonar_tpu.assets import hub as jax_hub
    from sonar_tpu.assets.store import ModelCard, default_store
    from sonar_tpu_torch.assets import hub
    from sonar_tpu_torch.assets import checkpoint as port_ckpt
    from sonar_tpu_torch.assets import store as port_store

    jcfg, tcfg = _cfgs("toy")
    _, jparams, _ = _decoders("toy")
    params = _PARAMS["toy"]
    shapes = {k: v.shape for k, v in ckpt.flatten_params(init_text_decoder_params(tcfg)).items()}
    assert shapes == {k: v.shape for k, v in ckpt.flatten_params(params).items()}

    path = tmp_path / "decoder.pt"
    torch.save({"model": _decoder_state(params, jcfg.num_decoder_layers)}, path)
    flat = ckpt.load_torch_state_dict(path)
    want_tree = ckpt.flatten_params(ckpt.text_decoder_params(flat))
    got_tree = ckpt.flatten_params(port_ckpt.text_decoder_params(port_ckpt.load_torch_state_dict(path)))
    assert want_tree.keys() == got_tree.keys()
    for k in want_tree:
        np.testing.assert_array_equal(want_tree[k], got_tree[k])

    rng = np.random.default_rng(9)
    seqs, lens = _seqs(rng, 2, 6, 200, [6, 3])
    memory = rng.normal(size=(2, 1, 32)).astype(np.float32)
    want = np.asarray(JaxDecoder(jcfg).forward(ckpt.text_decoder_params(flat), jnp.asarray(seqs),
                                               jnp.asarray(lens), jnp.asarray(memory)))
    with torch.inference_mode():
        got = load_text_decoder_checkpoint(path, tcfg)(
            torch.tensor(seqs), torch.tensor(lens), torch.tensor(memory)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)

    name = "torch_port_decoder_test_card"
    store, pstore = default_store(), port_store.default_store()
    store.register_model(ModelCard(name=name, family="sonar_text_decoder", arch="toy",
                                   checkpoint=str(path)))
    pstore.register_model(port_store.ModelCard(name=name, family="sonar_text_decoder",
                                               arch="toy", checkpoint=str(path)))
    try:
        port = hub.load_text_decoder(name, device="cpu")
        ref = jax_hub.load_text_decoder(name, quantize=False)
    finally:
        del store.models[name], pstore.models[name]
    np.testing.assert_allclose(port.score(seqs, lens, memory), ref.score(seqs, lens, memory),
                               atol=1e-4)
