"""The port's beam loop without host reads, and its dispatch-ahead API,
against ``sonar_tpu``'s on CPU.

Decoders: ``toy`` (D 32, 4 heads of 8) and a D 128 decoder of 2 heads of
64 over a 3000-row vocabulary (the blocked exact top-k), as in
``test_torch_port_decode.py``; pipelines on the toy NLLB tokenizer. Weights
and inputs come from seeds and go to both packages. Tolerances are that
file's: token ids and lengths identical, scores to 1e-5 (fp32 in two
frameworks), strings identical; within the port (chunk sizes, the async
pair, a step after the exit, the window) outputs are equal bit for bit.
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

from sonar_tpu.generation import beam_search as jbs  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jax_dec_archs  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_encoder_archs as jax_enc_archs  # noqa: E402
from sonar_tpu.nn import position as jpos  # noqa: E402
from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu_torch.assets.convert import text_decoder_from_numpy, text_encoder_from_numpy  # noqa: E402
from sonar_tpu_torch.generation import beam_search as tbs  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.generation.text_converter import (  # noqa: E402
    EmbeddingToTextConverter,
    TextTranslator,
)
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.nn import position as tpos  # noqa: E402
from sonar_tpu_torch.nn import transformer as ttr  # noqa: E402
from sonar_tpu_torch.runtime import stream_in_window  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402

TEXTS = ["hello world", "my name is paul", "i work as a teacher", "bonjour", "the cat sat",
         "je suis", "a b c d e"]


def _wide(archs):
    toy = archs.get("toy")
    return dataclasses.replace(
        toy, model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
        ffn_inner_dim=256, vocab_info=dataclasses.replace(toy.vocab_info, size=3000))


_DECODERS = {}


def _decoders(name):
    """(JAX runtime, port model on the CPU) of one config, fp32."""
    if name not in _DECODERS:
        if name == "toy":
            jcfg, tcfg = jax_dec_archs.get("toy"), sonar_text_decoder_archs.get("toy")
        else:
            jcfg, tcfg = _wide(jax_dec_archs), _wide(sonar_text_decoder_archs)
        params = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init_params(
            jax.random.PRNGKey(1)))
        _DECODERS[name] = (JitTextDecoder(JaxDecoder(jcfg), params, quantize=False),
                           text_decoder_from_numpy(params, tcfg))
    return _DECODERS[name]


def _memory(name, b=3, seed=6):
    d = 32 if name == "toy" else 128
    return np.random.default_rng(seed).normal(size=(b, 1, d)).astype(np.float32) * 2.0


def _search(model, memory, prefix, config, chunk):
    """The port's loop run directly: setup, ``run_chunks`` in chunks of
    ``chunk``, finish; -> (outputs, the final state, the steps run)."""
    vocab, k = model.config.vocab_info, config.beam_size
    cache_len = len(prefix) + config.max_gen_len + 1

    def step_fn(tokens, cache, ancestry):
        return model.step(tokens, cache, ancestry=ancestry, beam_size=k)

    with torch.inference_mode():
        mem = torch.tensor(np.repeat(memory, k, axis=0))
        cache = model.init_cache(mem, cache_len, beam_size=k)
        prefix_t = torch.tensor([prefix] * memory.shape[0])
        state = tbs.beam_setup(step_fn, cache, prefix_t, vocab.eos_idx, vocab.size, config,
                               pad_idx=vocab.pad_idx or 0, cache_len=cache_len)
        unk = vocab.unk_idx if config.unk_penalty else None
        ran = tbs.run_chunks(state, lambda st: tbs.beam_step(
            st, step_fn, vocab.eos_idx, vocab.size, config, unk), chunk)
        out = tuple(t.numpy() for t in tbs.beam_finish(state, vocab.eos_idx, config))
    return out, state, ran, step_fn


# Early exit (len_penalty 1 and 0), a negative penalty, the unk penalty,
# min_gen_len past the first EOS, normalize_scores=False, the length limit.
CONFIGS = [
    dict(beam_size=3, max_gen_len=10, len_penalty=1.0),
    dict(beam_size=3, max_gen_len=8, len_penalty=0.0),
    dict(beam_size=2, max_gen_len=9, len_penalty=-0.5),
    dict(beam_size=3, max_gen_len=7, unk_penalty=2.5),
    dict(beam_size=4, max_gen_len=8, min_gen_len=4),
    dict(beam_size=3, max_gen_len=6, normalize_scores=False),
    dict(beam_size=2, max_gen_len=3),
]


def _ids(kw):
    return "-".join(f"{a}={b}" for a, b in kw.items())


def _same_hypotheses(got, want):
    (gt, gs, gl), (wt, ws, wl) = got, want
    np.testing.assert_array_equal(gl, wl)
    for r in range(gt.shape[0]):
        for k in range(gt.shape[1]):
            assert gt[r, k, : gl[r, k]].tolist() == wt[r, k, : wl[r, k]].tolist()
    np.testing.assert_allclose(gs, ws, atol=1e-5)


@pytest.mark.parametrize("kwargs", CONFIGS, ids=_ids)
@pytest.mark.parametrize("name", ["toy", "wide"])
def test_loop_matches_jax_in_every_chunk_size(name, kwargs):
    """The loop in chunks of 1, 3 and 8 against ``JitTextDecoder.
    generate_beam`` (a batch of 4: JAX pads to a power of two, so the
    padded rows are none): identical hypotheses, scores to 1e-5; the three
    chunk sizes give equal outputs bit for bit, and the steps the device
    ran are the steps taken rounded up to the chunk."""
    jrun, model = _decoders(name)
    memory, prefix = _memory(name, b=4), [3, 7]
    config = tbs.BeamSearchConfig(**kwargs)
    want = jrun.generate_beam(memory, prefix, jbs.BeamSearchConfig(**kwargs))
    if not config.normalize_scores:  # the runtimes' len_penalty 0
        config = dataclasses.replace(config, normalize_scores=True, len_penalty=0.0)
    outs = {}
    for chunk in (1, 3, 8):
        outs[chunk], state, ran, _ = _search(model, memory, prefix, config, chunk)
        steps = int(state.step)
        assert bool(state.done) and 1 <= steps <= config.max_gen_len
        assert ran == -(-steps // chunk) * chunk
    _same_hypotheses(outs[1], want)
    for chunk in (3, 8):
        for got, ref in zip(outs[chunk], outs[1]):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_a_step_after_the_exit_changes_nothing(name):
    """Once ``done``, more body steps (the gated steps of a chunk) leave
    every tensor of the state as it was, ``step`` and ``done`` included,
    though the decoder runs and the cache index moves on."""
    _, model = _decoders(name)
    config = tbs.BeamSearchConfig(beam_size=3, max_gen_len=12)
    _, state, _, step_fn = _search(model, _memory(name), [3, 7], config, 1)
    fields = ("tokens", "scores", "fin_tokens", "fin_scores", "fin_lens", "anc", "logits",
              "step", "done")
    before = {f: getattr(state, f).clone() for f in fields}
    index = int(state.cache.index)
    vocab = model.config.vocab_info
    with torch.inference_mode():
        for _ in range(3):
            tbs.beam_step(state, step_fn, vocab.eos_idx, vocab.size, config)
    assert int(state.cache.index) == index + 3
    for f in fields:
        assert torch.equal(getattr(state, f), before[f]), f


def test_forced_steps_follow_the_host_decision():
    """``run_chunks(agree=...)`` (a mesh of several ranks): chunks are taken
    while ``agree`` says some rank is live, so a rank done on its own keeps
    stepping in lock step with the others, its steps gated: its state,
    ``step`` included, and its outputs stay those of the search alone, bit
    for bit; ``agree`` is asked once a chunk, with this rank's own flag."""
    _, model = _decoders("toy")
    config = tbs.BeamSearchConfig(beam_size=3, max_gen_len=10)
    memory, prefix = _memory("toy"), [3, 7]
    want, alone, _, _ = _search(model, memory, prefix, config, 1)
    calls = []

    def agree(flag):
        calls.append(flag)
        return len(calls) <= 4  # another rank goes on past the limit

    vocab, k = model.config.vocab_info, config.beam_size
    with torch.inference_mode():
        cache = model.init_cache(torch.tensor(np.repeat(memory, k, axis=0)),
                                 len(prefix) + config.max_gen_len + 1, beam_size=k)
        step_fn = lambda t, c, a: model.step(t, c, ancestry=a, beam_size=k)  # noqa: E731
        state = tbs.beam_setup(step_fn, cache, torch.tensor([prefix] * 3), vocab.eos_idx,
                               vocab.size, config, cache_len=len(prefix) + config.max_gen_len + 1)
        ran = tbs.run_chunks(state, lambda st: tbs.beam_step(
            st, step_fn, vocab.eos_idx, vocab.size, config), chunk=3, agree=agree)
        got = tuple(t.numpy() for t in tbs.beam_finish(state, vocab.eos_idx, config))
    assert ran == 3 * len(calls) > config.max_gen_len >= int(state.step) == int(alone.step)
    assert calls[0] and not calls[-1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_runtime_counts_steps_and_pads_to_a_power_of_two():
    """``generate_beam`` on the CPU: ``decode_steps`` counts the prefix and
    the search's steps (read from the device counter), ``device_steps``
    those the device ran (a chunk's gated steps included); a batch of 5
    decodes as JAX's padded 8 and gives its hypotheses."""
    jrun, model = _decoders("toy")
    trun = TorchTextDecoder(model, device="cpu")
    memory = _memory("toy", b=5, seed=9)
    config = tbs.BeamSearchConfig(beam_size=3, max_gen_len=10)
    got = trun.generate_beam(memory, [3, 7], config)
    want = jrun.generate_beam(memory, [3, 7], jbs.BeamSearchConfig(beam_size=3, max_gen_len=10))
    _same_hypotheses(got, want)
    padded = np.concatenate([memory, np.zeros((3, 1, 32), np.float32)])
    _, state, ran, _ = _search(model, padded, [3, 7], config, tbs.CHUNK_STEPS)
    assert trun.decode_steps == 2 + int(state.step)
    assert trun.device_steps == 2 + ran >= trun.decode_steps


@pytest.mark.parametrize("kwargs", CONFIGS[:4], ids=_ids)
def test_async_pair_is_generate_beam(kwargs):
    """``generate_beam_async`` + ``materialize_beam`` (on the CPU the handle
    comes back resolved) equal ``generate_beam``, with a tensor memory and
    a numpy one, and JAX's async pair."""
    jrun, model = _decoders("wide")
    trun = TorchTextDecoder(model, device="cpu")
    memory = _memory("wide", b=3, seed=2)
    config = tbs.BeamSearchConfig(**kwargs)
    want = trun.generate_beam(memory, [3, 7], config)
    handle = trun.generate_beam_async(torch.tensor(memory), [3, 7], config)
    assert handle.b == 3 and handle.copied is None and handle.settle is None
    got = trun.materialize_beam(handle)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jwant = jrun.materialize_beam(jrun.generate_beam_async(memory, [3, 7],
                                                           jbs.BeamSearchConfig(**kwargs)))
    _same_hypotheses(got, jwant)


# -- device positions ---------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 5, 17])
def test_positions_at_a_device_step_match_jax(step):
    """Sinusoidal (with the legacy pad offset) and learned encoders at a
    device step: the host-int rows, and JAX's ``dynamic_slice`` rows."""
    rng = np.random.default_rng(step)
    x = rng.normal(size=(2, 1, 16)).astype(np.float32)
    weight = rng.normal(size=(24, 16)).astype(np.float32)
    sin_t, sin_j = tpos.SinusoidalPositionEncoder(16, 24, 1), jpos.SinusoidalPositionEncoder(16, 24, 1)
    lrn_t, lrn_j = tpos.LearnedPositionEncoder(16, 24), jpos.LearnedPositionEncoder(16, 24)
    cases = ((lambda s: sin_t(torch.tensor(x), s), lambda s: sin_j(jnp.asarray(x), s)),
             (lambda s: lrn_t({"weight": torch.tensor(weight)}, torch.tensor(x), s),
              lambda s: lrn_j({"weight": jnp.asarray(weight)}, jnp.asarray(x), s)))
    for port, ref in cases:
        got = port(torch.tensor(step))
        np.testing.assert_array_equal(got.numpy(), port(step).numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(step, jnp.int32))),
                                   atol=1e-6)


def test_device_step_past_the_table_is_clamped_and_a_host_one_raises():
    """Past the table a device step reads the last rows, as JAX's
    ``dynamic_slice`` clamps; a host step raises."""
    x = np.random.default_rng(0).normal(size=(1, 2, 8)).astype(np.float32)
    enc, ref = tpos.SinusoidalPositionEncoder(8, 10), jpos.SinusoidalPositionEncoder(8, 10)
    got = enc(torch.tensor(x), torch.tensor(30))
    np.testing.assert_array_equal(got.numpy(), enc(torch.tensor(x), 8).numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(x), jnp.asarray(30))),
                               atol=1e-6)
    with pytest.raises(ValueError, match="exceed"):
        enc(torch.tensor(x), 9)


@pytest.mark.parametrize("beam", [False, True])
def test_decoder_step_at_the_device_index(beam):
    """``decoder_step`` writes at the cache's device index: five steps equal
    JAX's ``decoder_step`` (outputs and caches), and a step at an index past
    the cache writes its last slot, as JAX's ``dynamic_update_slice``
    clamps; the index moves on in place."""
    _, model = _decoders("toy")
    jparams = jax.tree_util.tree_map(jnp.asarray, _DECODERS["toy"][0].params)
    rng = np.random.default_rng(4)
    b, d, s_max, k = 2, 32, 6, (3 if beam else None)
    n = b * (k or 1)
    memory = rng.normal(size=(n, 1, d)).astype(np.float32)
    layers = model.params.tree()["decoder"]["layers"]
    jlayers = jparams["decoder"]["layers"]
    jcache = jtr.init_decoder_cache(jlayers, jnp.asarray(memory), 4, s_max, n, d, jnp.float32,
                                    beam_size=k)
    with torch.inference_mode():
        tcache = ttr.init_decoder_cache(layers, torch.tensor(memory), 4, s_max, n, d,
                                        torch.float32, beam_size=k)
        assert tcache.index.shape == () and tcache.index.dtype == torch.long
        for t in range(s_max + 1):
            if t == s_max:  # one step past the cache
                jcache = dataclasses.replace(jcache, index=jnp.asarray(s_max + 2, jnp.int32))
                tcache.index.fill_(s_max + 2)
            x = rng.normal(size=(n, 1, d)).astype(np.float32)
            anc = np.tile(np.arange(k), b)[:, None].repeat(s_max, 1).astype(np.int32) if beam \
                else None
            kw = dict(ancestry=None if anc is None else torch.tensor(anc), beam_size=k)
            got, tcache = ttr.decoder_step(layers, torch.tensor(x), tcache, None, 4, "relu", **kw)
            jkw = dict(ancestry=None if anc is None else jnp.asarray(anc), beam_size=k)
            want, jcache = jtr.decoder_step(jlayers, jnp.asarray(x), jcache, None, 4, "relu",
                                            **jkw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert int(tcache.index) == int(jcache.index) == s_max + 3
        np.testing.assert_allclose(tcache.self_k.numpy(), np.asarray(jcache.self_k), atol=1e-5)
        np.testing.assert_allclose(tcache.self_v.numpy(), np.asarray(jcache.self_v), atol=1e-5)


# -- converter, stream and pipelines ------------------------------------------------------


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(port tokenizer, JAX tokenizer, JAX encoder + params, JAX decoder +
    params, port encoder, port decoder) over the toy NLLB vocabulary."""
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    tmp = tmp_path_factory.mktemp("async_decode")
    path = tmp / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    tok = NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")
    size = tok.vocab_info.size
    jcfg = dataclasses.replace(jax_dec_archs.get("toy"), vocab_info=dataclasses.replace(
        jax_dec_archs.get("toy").vocab_info, size=size))
    tcfg = dataclasses.replace(sonar_text_decoder_archs.get("toy"), vocab_info=dataclasses.replace(
        sonar_text_decoder_archs.get("toy").vocab_info, size=size))
    dparams = jax.tree_util.tree_map(np.asarray, JaxDecoder(jcfg).init_params(
        jax.random.PRNGKey(4)))
    ecfg = jax_enc_archs.get("toy")
    eparams = jax.tree_util.tree_map(np.asarray, JaxEncoder(ecfg).init_params(
        jax.random.PRNGKey(0)))
    return (tok, build_toy_nllb(tmp), (JaxEncoder(ecfg), eparams), (JaxDecoder(jcfg), dparams),
            text_encoder_from_numpy(eparams, sonar_text_encoder_archs.get("toy")),
            text_decoder_from_numpy(dparams, tcfg))


def test_dispatch_convert_then_finish_is_batch_convert(bundle):
    """Beam: ``finish_convert(dispatch_convert(x))`` is ``batch_convert(x)``
    for numpy and tensor embeddings, and handles resolved out of order give
    the same strings; sampling: ``dispatch_convert`` returns the strings."""
    from sonar_tpu_torch.generation.sampling import TopKSampler

    tok, *_, tdec = bundle
    dec = TorchTextDecoder(tdec, device="cpu")
    emb = np.random.default_rng(8).normal(size=(7, 32)).astype(np.float32) * 3.0
    config = tbs.BeamSearchConfig(beam_size=3, max_gen_len=10)
    conv = EmbeddingToTextConverter(dec, tok, "fra_Latn", config)
    want = conv.batch_convert(emb)
    assert len(want) == 7 and any(want)
    first, second = conv.dispatch_convert(emb[:4]), conv.dispatch_convert(torch.tensor(emb[4:]))
    assert conv.finish_convert(second) + conv.finish_convert(first) == want[4:] + want[:4]
    sampling = EmbeddingToTextConverter(dec, tok, "fra_Latn", config, sampler=TopKSampler(1))
    handle = sampling.dispatch_convert(emb)
    assert isinstance(handle, list) and sampling.finish_convert(handle) == handle
    assert handle == sampling.batch_convert(emb)


def test_stream_in_window_keeps_the_window():
    """``stream_in_window`` finishes in order, with at most ``window``
    dispatched beyond the one it finishes; an empty input yields nothing."""
    for window in (1, 2, 4):
        log = []

        def handles():
            for i in range(5):
                log.append(("dispatch", i))
                yield i

        def finish(i):
            log.append(("finish", i))
            return i * 10

        assert list(stream_in_window(handles(), finish, window)) == [0, 10, 20, 30, 40]
        for i in range(5):
            dispatched = log[: log.index(("finish", i))].count
            assert sum(dispatched(("dispatch", j)) for j in range(5)) == min(5, i + window + 1)
    assert list(stream_in_window(iter([]), lambda h: h, 2)) == []


def test_translate_stream_matches_sequential_and_jax(bundle):
    """``translate_stream`` with windows 1, 2 and 4 over chunks of 3, 3 and 1
    texts equals sequential ``batch_translate`` and JAX's
    ``translate_stream``; an empty iterator yields nothing; the pipeline,
    which streams, gives the same strings as JAX's."""
    from sonar_tpu.generation.text_converter import TextTranslator as JaxTranslator
    from sonar_tpu.inference_pipelines.text import JitTextEncoder
    from sonar_tpu.inference_pipelines.text import TextToTextModelPipeline as JaxPipe
    from sonar_tpu_torch.inference_pipelines.text import TextToTextModelPipeline, TorchTextEncoder

    tok, jtok, (jenc, eparams), (jdec, dparams), tenc, tdec = bundle
    kw = dict(beam_size=2, max_gen_len=8)
    dec = TorchTextDecoder(tdec, device="cpu")
    translator = TextTranslator(TorchTextEncoder(tenc, device="cpu"), dec, tok, "eng_Latn",
                                "fra_Latn", tbs.BeamSearchConfig.from_kwargs(512, **kw))
    jencoder = JitTextEncoder(jenc, eparams)
    jdecoder = JitTextDecoder(jdec, dparams, quantize=False)
    jtranslator = JaxTranslator(jencoder, jdecoder, jtok, "eng_Latn", "fra_Latn",
                                jbs.BeamSearchConfig.from_kwargs(512, **kw))
    chunks = [TEXTS[:3], TEXTS[3:6], TEXTS[6:]]
    want = [translator.batch_translate(c) for c in chunks]
    assert want == list(jtranslator.translate_stream(iter(chunks), window=2))
    for window in (1, 2, 4):
        assert list(translator.translate_stream(iter(chunks), window=window)) == want, window
    assert list(translator.translate_stream(iter([]), window=2)) == []
    got = TextToTextModelPipeline(tenc, tdec, tok, device="cpu").predict(
        TEXTS, source_lang="eng_Latn", target_lang="fra_Latn", batch_size=3, **kw)
    assert got == [s for c in want for s in c]
    assert got == JaxPipe(jencoder, jdecoder, jtok, quantize=False).predict(
        TEXTS, source_lang="eng_Latn", target_lang="fra_Latn", batch_size=3, **kw)


def test_speech_to_text_window_matches_batch_by_batch(bundle):
    """``SpeechToTextModelPipeline.predict`` (two batches in flight) on 5
    clips in batches of 2 equals converting each batch's embeddings in
    turn, and JAX's pipeline on the same weights."""
    from sonar_tpu.inference_pipelines import speech as jspeech
    from sonar_tpu.models.sonar_speech.config import sonar_speech_encoder_archs as jax_speech
    from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeechEncoder
    from sonar_tpu_torch.assets.convert import speech_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines import speech
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs

    tok, jtok, _, (jdec, dparams), _, tdec = bundle
    scfg = jax_speech.get("toy")
    sparams = jax.tree_util.tree_map(np.asarray, JaxSpeechEncoder(scfg).init_params(
        jax.random.PRNGKey(0)))
    tenc = speech.TorchSpeechEncoder(speech_encoder_from_numpy(
        sparams, sonar_speech_encoder_archs.get("toy")), device="cpu")
    rng = np.random.default_rng(5)
    clips = [(0.3 * rng.standard_normal(int(s * 16000))).astype(np.float32)
             for s in (1.0, 1.6, 0.7, 1.2, 0.9)]
    kw = dict(beam_size=2, max_gen_len=6)
    dec = TorchTextDecoder(tdec, device="cpu")
    got = speech.SpeechToTextModelPipeline(tenc, dec, tok, device="cpu").predict(
        clips, target_lang="fra_Latn", batch_size=2, **kw)
    conv = EmbeddingToTextConverter(dec, tok, "fra_Latn",
                                    tbs.BeamSearchConfig.from_kwargs(dec.max_target_len, **kw))
    want = [s for i in range(0, 5, 2)
            for s in conv.batch_convert(tenc.encode_waveforms(clips[i:i + 2]))]
    assert len(got) == 5 and got == want
    jpipe = jspeech.SpeechToTextModelPipeline(
        jspeech.JitSpeechEncoder(JaxSpeechEncoder(scfg), sparams),
        JitTextDecoder(jdec, dparams, quantize=False), jtok)
    assert got == jpipe.predict(clips, target_lang="fra_Latn", batch_size=2, **kw)


def test_a_capture_tallies_its_own_thread_only():
    """``ops.cuda.launched`` inside ``captured_launches`` goes to the
    capture's tally, not the counter, while a launch another thread makes
    meanwhile is counted at once; ``add_launches`` then counts replays."""
    import threading

    from sonar_tpu_torch.ops import cuda as kernels
    from sonar_tpu_torch.ops.cuda import beam_attend

    before = beam_attend.MASKED_LAUNCHES
    with kernels.captured_launches() as tally:
        for _ in range(3):
            kernels.launched("beam_attend", "MASKED_LAUNCHES")
        other = threading.Thread(target=kernels.launched, args=("beam_attend", "MASKED_LAUNCHES"))
        other.start()
        other.join()
    assert tally == {("beam_attend", "MASKED_LAUNCHES"): 3}
    assert beam_attend.MASKED_LAUNCHES == before + 1
    kernels.add_launches(tally, replays=4)
    assert beam_attend.MASKED_LAUNCHES == before + 13
    kernels.launched("beam_attend", "MASKED_LAUNCHES")
    assert beam_attend.MASKED_LAUNCHES == before + 14 and tally[("beam_attend",
                                                                  "MASKED_LAUNCHES")] == 3


def test_warmup_decodes_every_padded_batch_size(bundle):
    """The decode pipelines' ``warmup`` runs one beam decode at each size a
    batch of up to ``batch_size`` rows pads to (1, 2, 4, 8 for 5), so that
    a tail batch finds its program captured."""
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline

    tok, tdec = bundle[0], bundle[-1]
    dec = TorchTextDecoder(tdec, device="cpu")
    seen = []
    generate = dec.generate_beam_async
    dec.generate_beam_async = lambda memory, *a: seen.append(len(memory)) or generate(memory, *a)
    pipe = EmbeddingToTextModelPipeline(dec, tok, device="cpu")
    assert pipe.warmup(batch_size=5, target_lang="fra_Latn", beam_size=2, max_gen_len=3) == 4
    assert seen == [1, 2, 4, 8]
