"""The port's kernel-selection API (``sonar_tpu_torch.ops.gates``) against
``sonar_tpu``'s (``no_tpu_kernels``, ``set_attention_impl``,
``set_ffn_impl``), on the CPU.

- ``no_cuda_kernels()`` nests, stays in its thread, and
  ``kernel_gate_scope`` is it or a null context, as
  ``tests/unit/test_kernel_scope.py`` pins JAX's scope;
- both setters reject what JAX's reject;
- every kernel gate (#1, #2 with #3-LN, #3, #5, #6, #8 and the sampling
  draw) takes its plain path under the scope: its wrapper, patched where
  the gate reads it to raise, raises without the scope and is never called
  inside it, on a runtime built outside the scope;
- ``set_attention_impl("cuda")`` sends S 8 to flash, ``"plain"`` keeps #5
  and #6 off, ``set_ffn_impl("plain")`` the standalone FFN only;
- a captured decode's cache key follows the scope and both setters;
- the port under ``no_cuda_kernels()`` against JAX under
  ``no_tpu_kernels()`` (XLA on the CPU) on small models: ``toy`` and a D 128
  config of two heads of 64, which reaches every gate.

Tolerances (those of the port's parity tests): int8 text embeddings cosine
>= 0.999 per row of length >= 1; fp32 text embeddings atol 2e-4; fp32
speech embeddings atol 5e-4; fp32 beam search identical tokens and
lengths, scores atol 1e-5. Kernels-on against kernels-off on the CPU (each
wrapper's plain version against the gate's plain path): fp32 atol 1e-4,
int8 cosine >= 0.999, decode tokens equal.
"""

import dataclasses
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from sonar_tpu.data.collate import SequenceBatch as JaxBatch  # noqa: E402
from sonar_tpu.generation import beam_search as jbs  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.inference_pipelines import speech as jspeech  # noqa: E402
from sonar_tpu.inference_pipelines.text import JitTextEncoder  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jspeech_cfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeechEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_decoder_archs as jax_dec_archs  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_encoder_archs as jax_enc_archs  # noqa: E402
from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.nn.conformer import ConformerConfig as JaxConformerConfig  # noqa: E402
from sonar_tpu.ops import attention as jattn  # noqa: E402
from sonar_tpu_torch import ops  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    speech_encoder_from_numpy,
    text_decoder_from_numpy,
    text_encoder_from_numpy,
)
from sonar_tpu_torch.data.collate import SequenceBatch  # noqa: E402
from sonar_tpu_torch.generation import decoder_runtime, sampling  # noqa: E402
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.inference_pipelines import speech  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.models.sonar_text import (  # noqa: E402
    sonar_text_decoder_archs,
    sonar_text_encoder_archs,
)
from sonar_tpu_torch.nn import conformer, transformer  # noqa: E402
from sonar_tpu_torch.ops import attention, gates  # noqa: E402
from sonar_tpu_torch.ops.cuda import (  # noqa: E402
    attn_block,
    beam_attend,
    ffn,
    flash,
    relpos_flash,
    short_attn,
)


@pytest.fixture(autouse=True)
def _auto_impls():
    """Every test starts and ends with both setters at ``"auto"`` (they are
    process-wide, as JAX's)."""
    gates.set_attention_impl("auto")
    gates.set_ffn_impl("auto")
    yield
    gates.set_attention_impl("auto")
    gates.set_ffn_impl("auto")
    jattn.set_attention_impl("auto")
    jtr.set_ffn_impl("auto")


# -- the scope ------------------------------------------------------------------------------


def test_no_cuda_kernels_nesting():
    assert not gates.cuda_kernels_disabled()
    with gates.no_cuda_kernels():
        assert gates.cuda_kernels_disabled()
        with gates.no_cuda_kernels():
            assert gates.cuda_kernels_disabled()
        assert gates.cuda_kernels_disabled()
    assert not gates.cuda_kernels_disabled()


def test_no_cuda_kernels_thread_isolation():
    """A scope entered on one thread is not seen by another."""
    entered = threading.Event()
    release = threading.Event()
    seen_in_other = []

    def holder():
        with gates.no_cuda_kernels():
            entered.set()
            release.wait(timeout=10)

    t = threading.Thread(target=holder)
    t.start()
    try:
        assert entered.wait(timeout=10)
        assert not gates.cuda_kernels_disabled()
        p = threading.Thread(target=lambda: seen_in_other.append(gates.cuda_kernels_disabled()))
        p.start()
        p.join(timeout=10)
        assert not p.is_alive() and seen_in_other == [False]
    finally:
        release.set()
        t.join(timeout=10)
    assert not t.is_alive()


def test_kernel_gate_scope_helper():
    with gates.kernel_gate_scope(True):
        assert gates.cuda_kernels_disabled()
    with gates.kernel_gate_scope(False):
        assert not gates.cuda_kernels_disabled()


def test_kernels_allowed_is_the_scope_and_autograd():
    a, b = torch.ones(2), torch.ones(2, requires_grad=True)
    assert gates.kernels_allowed() and gates.kernels_allowed(a, None)
    assert not gates.kernels_allowed(a, b)
    with torch.no_grad():
        assert gates.kernels_allowed(b)
    with gates.no_cuda_kernels():
        assert not gates.kernels_allowed() and not gates.kernels_allowed(a)


# -- the setters -----------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["attention", "ffn"])
def test_setters_reject_unknown_values_as_jax_does(which):
    port, jax_setter, get = {
        "attention": (attention.set_attention_impl, jattn.set_attention_impl,
                      gates.attention_impl),
        "ffn": (transformer.set_ffn_impl, jtr.set_ffn_impl, gates.ffn_impl),
    }[which]
    for bad in ("fast", "", "AUTO"):
        with pytest.raises(ValueError):
            port(bad)
        with pytest.raises(ValueError):
            jax_setter(bad)
    assert get() == "auto"
    values = gates.ATTENTION_IMPLS if which == "attention" else gates.FFN_IMPLS
    for value in values:
        port(value)
        assert get() == value


def test_setters_are_the_gates_own():
    """The names JAX keeps in ``ops.attention`` and ``nn.transformer`` are
    there in the port too, and ``sonar_tpu_torch.ops`` exports them."""
    assert attention.set_attention_impl is gates.set_attention_impl is ops.set_attention_impl
    assert transformer.set_ffn_impl is gates.set_ffn_impl is ops.set_ffn_impl
    assert ops.no_cuda_kernels is gates.no_cuda_kernels


# -- every gate under the scope ---------------------------------------------------------------


class KernelCalled(Exception):
    pass


def _raising(name):
    def call(*args, **kwargs):
        raise KernelCalled(name)
    return call


def _text_cfg():
    toy = sonar_text_encoder_archs.get("toy")
    return dataclasses.replace(toy, model_dim=128, num_encoder_attn_heads=2, ffn_inner_dim=512)


def _text_encoder(dtype=torch.float32, quantize=False, fuse_qkv=True, seed=2):
    from sonar_tpu_torch.assets.convert import init_text_encoder_params

    cfg = _text_cfg()
    model = text_encoder_from_numpy(init_text_encoder_params(cfg, seed=seed), cfg, dtype)
    return TorchTextEncoder(model, fuse_qkv=fuse_qkv, quantize=quantize, device="cpu")


def _text_batch(b, s, seed=5):
    rng = np.random.default_rng(seed)
    lens = np.maximum(1, s - rng.integers(0, s // 2, size=b)).astype(np.int32)
    lens[0] = s
    seqs = rng.integers(4, 1000, size=(b, s)).astype(np.int32)
    for i, n in enumerate(lens):
        seqs[i, n:] = 1
    return SequenceBatch(seqs=seqs, seq_lens=lens, true_batch=b)


def _speech_cfg(archs, conformer_cfg):
    base = archs.get("toy")
    return dataclasses.replace(
        base,
        conformer=conformer_cfg(model_dim=128, num_layers=2, num_heads=2, ffn_inner_dim=256,
                                depthwise_kernel_size=7),
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=128),
        model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256,
    )


PORT_SPEECH = _speech_cfg(sonar_speech_encoder_archs, conformer.ConformerConfig)
JAX_SPEECH = _speech_cfg(jspeech_cfg.sonar_speech_encoder_archs, JaxConformerConfig)


def _dec_cfg(archs):
    toy = archs.get("toy")
    return dataclasses.replace(
        toy, model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
        ffn_inner_dim=256, vocab_info=dataclasses.replace(toy.vocab_info, size=3000))


def _decoder():
    from sonar_tpu_torch.assets.convert import init_text_decoder_params

    cfg = _dec_cfg(sonar_text_decoder_archs)
    return TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg, seed=0), cfg),
                            device="cpu")


def _memory(rows=3, d=128, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, 1, d)).astype(np.float32) * 2.0


def _case(name):
    """(modules and names of the wrappers the gate reaches, run(), how to
    compare the kernels-on and kernels-off outputs) of one gate, its
    runtime built here, outside any scope."""
    def close(atol):
        return lambda got, want: np.testing.assert_allclose(got, want, atol=atol)

    def cos(got, want):
        c = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert c.min() >= 0.999

    def equal(got, want):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    if name == "short_attn":  # #1: S 8..128, fewer tokens than the block gate's
        enc, batch = _text_encoder(), _text_batch(2, 16)
        return [(short_attn, "short_qkv_attention")], lambda: enc.encode_batch(batch), close(1e-4)
    if name == "block":  # #2 + #3-LN: int8, fused q/k/v, S >= 8, >= 2048 tokens
        enc, batch = _text_encoder(quantize=True), _text_batch(64, 32)
        return ([(attn_block, "fused_attn_block"), (ffn, "fused_int8_ffn_ln")],
                lambda: enc.encode_batch(batch), cos)
    if name == "ffn":  # #3 alone: int8, q/k/v unfused (past the block gate), 2048 tokens
        enc, batch = _text_encoder(quantize=True, fuse_qkv=False), _text_batch(8, 256)
        return [(ffn, "fused_int8_ffn")], lambda: enc.encode_batch(batch), cos
    if name == "flash":  # #5: S >= 256
        enc, batch = _text_encoder(), _text_batch(2, 256)
        return [(flash, "flash_attention")], lambda: enc.encode_batch(batch), close(1e-4)
    if name == "relpos":  # #6: 128 <= S <= 2048
        from sonar_tpu_torch.assets.convert import init_speech_encoder_params

        model = speech_encoder_from_numpy(init_speech_encoder_params(PORT_SPEECH, seed=0),
                                          PORT_SPEECH)
        enc = speech.TorchSpeechEncoder(model, device="cpu")
        waves = [np.random.default_rng(3).normal(size=n).astype(np.float32) * 0.1
                 for n in (48000, 40000)]  # 3 s and 2.5 s: S 149 and 124 in one batch
        return ([(relpos_flash, "relpos_flash_attention_v2")],
                lambda: enc.encode_waveforms(waves), close(1e-4))
    if name == "beam":  # #8: every beam step
        dec, memory = _decoder(), _memory()
        config = BeamSearchConfig(beam_size=3, max_gen_len=8)
        return ([(beam_attend, "beam_masked_attend")],
                lambda: dec.generate_beam(memory, [3, 7], config), equal)
    assert name == "gumbel_max"  # the sampling step's draw
    dec, memory = _decoder(), _memory()
    sampler = sampling.TopKSampler(10)
    return ([(sampling, "gumbel_max")],
            lambda: dec.generate_sample(memory, [3, 7], sampler, max_gen_len=8, seed=4), equal)


@pytest.mark.parametrize("name", ["short_attn", "block", "ffn", "flash", "relpos", "beam",
                                  "gumbel_max"])
def test_gate_takes_its_plain_path_under_the_scope(name, monkeypatch):
    wrappers, run, compare = _case(name)
    want = run()
    for module, attr in wrappers:
        monkeypatch.setattr(module, attr, _raising(attr))
    with pytest.raises(KernelCalled):
        run()
    with gates.no_cuda_kernels():
        got = run()
    compare(got, want)


def _counting(monkeypatch, module, attr):
    calls = []
    fn = getattr(module, attr)
    monkeypatch.setattr(module, attr, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_attention_impl_cuda_sends_short_sequences_to_flash(monkeypatch):
    """Unfused self-attention at S 8 (the fused layout's S 8..128 takes #1,
    which no setter governs): sdpa under ``"auto"``, flash under
    ``"cuda"``, in each of the 2 layers, and never inside the scope."""
    calls = _counting(monkeypatch, flash, "flash_attention")
    enc, batch = _text_encoder(fuse_qkv=False), _text_batch(3, 8)
    want = enc.encode_batch(batch)
    assert calls == []
    attention.set_attention_impl("cuda")
    got = enc.encode_batch(batch)
    assert len(calls) == 2
    np.testing.assert_allclose(got, want, atol=1e-4)
    with gates.no_cuda_kernels():
        enc.encode_batch(batch)
    assert len(calls) == 2


def test_attention_impl_plain_turns_flash_and_relpos_off(monkeypatch):
    flash_calls = _counting(monkeypatch, flash, "flash_attention")
    relpos_calls = _counting(monkeypatch, relpos_flash, "relpos_flash_attention_v2")
    ffn_calls = _counting(monkeypatch, ffn, "fused_int8_ffn")
    enc, batch = _text_encoder(quantize=True, fuse_qkv=False), _text_batch(8, 256)
    want = enc.encode_batch(batch)
    assert len(flash_calls) == 2 and len(ffn_calls) == 2
    attention.set_attention_impl("plain")
    got = enc.encode_batch(batch)
    assert len(flash_calls) == 2 and len(ffn_calls) == 4  # the FFN is not the setter's
    c = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert c.min() >= 0.999
    assert not conformer._use_relpos_kernel(None, 512, 64)
    attention.set_attention_impl("cuda")
    assert conformer._use_relpos_kernel(None, 512, 64)
    assert not conformer._use_relpos_kernel(None, 2049, 64)  # the shape gate holds
    assert relpos_calls == []


def test_attention_impl_plain_keeps_the_block_to_its_one_pass_step(monkeypatch):
    """The default int8 encoder (q/k/v fused) at S 256: under ``"auto"``
    each of the 2 layers runs #2, whose attention step past S 128 is #5's
    two-pass core; under ``"plain"`` no #2 and no flash there (as in JAX,
    whose block gate ends at S 128) but the standalone #3, with the same
    embeddings. At S 32, where #2's step is its one-pass core, the block
    still runs under ``"plain"``."""
    block_calls = _counting(monkeypatch, attn_block, "fused_attn_block")
    flash_calls = _counting(monkeypatch, flash, "flash_attention")
    ffn_calls = _counting(monkeypatch, ffn, "fused_int8_ffn")
    enc, batch = _text_encoder(quantize=True), _text_batch(8, 256)
    want = enc.encode_batch(batch)
    assert (len(block_calls), len(flash_calls), len(ffn_calls)) == (2, 0, 0)
    attention.set_attention_impl("plain")
    got = enc.encode_batch(batch)
    assert (len(block_calls), len(flash_calls), len(ffn_calls)) == (2, 0, 2)
    c = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert c.min() >= 0.999
    enc.encode_batch(_text_batch(64, 32))
    assert len(block_calls) == 4


def test_ffn_impl_plain_turns_only_the_standalone_ffn_off(monkeypatch):
    ffn_calls = _counting(monkeypatch, ffn, "fused_int8_ffn")
    block_calls = _counting(monkeypatch, attn_block, "fused_attn_block")
    transformer.set_ffn_impl("plain")
    _text_encoder(quantize=True, fuse_qkv=False).encode_batch(_text_batch(8, 256))
    assert ffn_calls == []
    _text_encoder(quantize=True).encode_batch(_text_batch(64, 32))
    _text_encoder(quantize=True).encode_batch(_text_batch(8, 256))
    assert len(block_calls) == 4  # the block kernels are not the setter's


def test_graph_key_follows_the_settings():
    key = decoder_runtime._graph_key
    base = key(32, 2, "config")
    assert base == (32, 2, "config", (False, "auto", "auto"))
    with gates.no_cuda_kernels():
        off = key(32, 2, "config")
    attention.set_attention_impl("plain")
    plain_attn = key(32, 2, "config")
    attention.set_attention_impl("auto")
    transformer.set_ffn_impl("plain")
    plain_ffn = key(32, 2, "config")
    transformer.set_ffn_impl("auto")
    assert len({base, off, plain_attn, plain_ffn}) == 4
    assert key(32, 2, "config") == base


# -- the port under its scope against JAX under its scope --------------------------------------


def _jax_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _text_cfgs(name):
    if name == "toy":
        return jax_enc_archs.get("toy"), sonar_text_encoder_archs.get("toy")
    base = dict(model_dim=128, num_encoder_attn_heads=2, ffn_inner_dim=512)
    return (dataclasses.replace(jax_enc_archs.get("toy"), **base),
            dataclasses.replace(sonar_text_encoder_archs.get("toy"), **base))


@pytest.mark.parametrize("name", ["toy", "wide"])
@pytest.mark.parametrize("mode", ["int8", "fp32"])
def test_text_under_the_scopes_matches_jax(name, mode):
    """int8 at [64, 32] (the block gate's shape) and fp32 at [8, 256]
    (flash's), each with ragged rows."""
    jcfg, tcfg = _text_cfgs(name)
    params = _jax_np(JaxEncoder(jcfg).init_params(jax.random.PRNGKey(2)))
    quantize = mode == "int8"
    batch = _text_batch(64, 32) if quantize else _text_batch(8, 256)
    port = TorchTextEncoder(text_encoder_from_numpy(params, tcfg), quantize=quantize,
                            device="cpu")
    jenc = JitTextEncoder(JaxEncoder(jcfg), params, quantize=quantize)
    with gates.no_cuda_kernels():
        got = port.encode_batch(batch)
    with jattn.no_tpu_kernels():
        want = np.asarray(jenc.encode_batch(JaxBatch(seqs=batch.seqs, seq_lens=batch.seq_lens,
                                                     true_batch=batch.true_batch)), np.float32)
    if quantize:
        c = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert c.min() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_speech_under_the_scopes_matches_jax():
    """fp32 clips of 1.5-5 s (S 74-249: both sides of #6's gate), two
    batches of 3."""
    from sonar_tpu_torch.assets.convert import init_speech_encoder_params

    params = init_speech_encoder_params(PORT_SPEECH, seed=0)
    rng = np.random.default_rng(5)
    clips = [(0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * np.arange(int(s * 16000)) / 16000)
              + 0.05 * rng.standard_normal(int(s * 16000))).astype(np.float32)
             for s in (3.0, 1.5, 5.0, 2.0, 4.2, 1.0)]
    port = speech.SpeechToEmbeddingModelPipeline(speech.TorchSpeechEncoder(
        speech_encoder_from_numpy(params, PORT_SPEECH), device="cpu"))
    jax_params = jax.tree_util.tree_map(np.asarray, params)
    jpipe = jspeech.SpeechToEmbeddingModelPipeline(
        jspeech.JitSpeechEncoder(JaxSpeechEncoder(JAX_SPEECH), jax_params))
    with gates.no_cuda_kernels():
        got = port.predict(clips, batch_size=3)
    with jattn.no_tpu_kernels():
        want = np.asarray(jpipe.predict(clips, batch_size=3), np.float32)
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("name", ["toy", "wide"])
def test_beam_search_under_the_scopes_matches_jax(name):
    if name == "toy":
        jcfg, tcfg = jax_dec_archs.get("toy"), sonar_text_decoder_archs.get("toy")
    else:
        jcfg, tcfg = _dec_cfg(jax_dec_archs), _dec_cfg(sonar_text_decoder_archs)
    params = _jax_np(JaxDecoder(jcfg).init_params(jax.random.PRNGKey(1)))
    port = TorchTextDecoder(text_decoder_from_numpy(params, tcfg), device="cpu")
    jdec = JitTextDecoder(JaxDecoder(jcfg), params, quantize=False)
    memory = _memory(3, tcfg.model_dim, seed=6)
    kwargs = dict(beam_size=3, max_gen_len=10, len_penalty=0.7)
    with gates.no_cuda_kernels():
        tt, ts, tl = port.generate_beam(memory, [3, 7], BeamSearchConfig(**kwargs))
    with jattn.no_tpu_kernels():
        jt, js, jl = jdec.generate_beam(memory, [3, 7], jbs.BeamSearchConfig(**kwargs))
    np.testing.assert_array_equal(tl, jl)
    for r in range(3):
        for k in range(3):
            assert tt[r, k, : tl[r, k]].tolist() == jt[r, k, : jl[r, k]].tolist()
    np.testing.assert_allclose(ts, js, atol=1e-5)
