"""The port's speech -> embedding path against ``sonar_tpu`` on CPU: fbank,
the attention pooler's decoder stack, the whole encoder, the pipeline, the
weight bridge, and a run without JAX.

The encoder tests use a small config that reaches the rel-pos kernel gate
(D 128, 2 heads of 64, FFN 256, 2 Conformer layers, depthwise kernel 7,
2 pooler layers, 80 mel bins); ``toy`` (head dim 8) never does. On CPU both
packages take their plain lowerings except that the port's clips of
S >= 128 go through the v2 kernel's plain version (the kernel's math).

Tolerances:
- fbank: atol 2e-4 on the standardised features (two FFT implementations;
  the log amplifies their fp32 differences in quiet bins), frame counts
  equal, mel banks and window equal;
- fp32 decoder stack atol 2e-5; fp32 embeddings from the same fbank
  features atol 1e-4 (two Conformer layers of fp32 products in other
  orders); fp32 embeddings from waveforms atol 5e-4 (embeddings of scale
  ~3; the two fbanks' feature differences pass through the encoder);
- bf16 embeddings, and fp32 ones from bf16 features: cosine >= 0.999 per
  clip (a bf16 rounding may flip between the two); int8 (quantize=True):
  cosine >= 0.999 per clip (an int8 rounding may flip).
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

from sonar_tpu.assets.checkpoint_speech import speech_encoder_params  # noqa: E402
from sonar_tpu.data.audio import write_wav  # noqa: E402
from sonar_tpu.inference_pipelines import speech as jspeech  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jcfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeechEncoder  # noqa: E402
from sonar_tpu.nn import transformer as jtr  # noqa: E402
from sonar_tpu.nn.conformer import ConformerConfig as JaxConformerConfig  # noqa: E402
from sonar_tpu.ops import fbank as jfbank  # noqa: E402
from sonar_tpu.ops import masks as jmasks  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    init_speech_encoder_params,
    load_speech_encoder_checkpoint,
    speech_encoder_from_numpy,
    speech_encoder_params_from_state,
)
from sonar_tpu_torch.inference_pipelines import speech  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.nn import conformer, transformer  # noqa: E402
from sonar_tpu_torch.ops import fbank, masks  # noqa: E402
from sonar_tpu_torch.ops.cuda import relpos_flash  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _row_cos(a, b):
    a, b = _np(a), _np(b)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _wide(arch_module, conformer_cfg):
    """The toy arch widened to reach the kernel gate."""
    base = arch_module.get("toy")
    return dataclasses.replace(
        base,
        conformer=conformer_cfg(model_dim=128, num_layers=2, num_heads=2, ffn_inner_dim=256,
                                depthwise_kernel_size=7),
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=128),
        model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256,
    )


JAX_CFG = _wide(jcfg.sonar_speech_encoder_archs, JaxConformerConfig)
PORT_CFG = _wide(sonar_speech_encoder_archs, conformer.ConformerConfig)


@pytest.fixture(scope="module")
def wide_params():
    params = JaxSpeechEncoder(JAX_CFG).init_params(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(11)
    # Non-trivial batch-norm statistics and v_bias (init makes them identity / 0).
    layers = params["encoder"]["layers"]
    bn = layers["conv"]["batch_norm"]
    for k in bn:
        bn[k] = (rng.uniform(0.5, 1.5, bn[k].shape) if k in ("weight", "running_var")
                 else rng.standard_normal(bn[k].shape) * 0.1).astype(np.float32)
    sdpa = layers["self_attn"]["sdpa"]
    sdpa["v_bias"] = (rng.standard_normal(sdpa["v_bias"].shape) * 0.1).astype(np.float32)
    return params


def _jax_pipeline(params, dtype, quantize=False, fbank_dtype=None):
    model = JaxSpeechEncoder(JAX_CFG, dtype=DT[dtype][1])
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, DT[dtype][1]), params)
    enc = jspeech.JitSpeechEncoder(model, jparams, quantize=quantize, fbank_dtype=fbank_dtype)
    return jspeech.SpeechToEmbeddingModelPipeline(enc)


def _port_pipeline(params, dtype, quantize=False, fbank_dtype=None):
    model = speech_encoder_from_numpy(params, PORT_CFG, DT[dtype][0])
    return speech.SpeechToEmbeddingModelPipeline(
        speech.TorchSpeechEncoder(model, quantize=quantize, fbank_dtype=fbank_dtype,
                                  device="cpu"))


def _clips(seconds, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for sec in seconds:
        n = int(sec * 16000)
        t = np.arange(n) / 16000.0
        tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t)
        out.append((tone + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


# -- fbank ----------------------------------------------------------------------------------


def test_fbank_tables_equal_jax():
    cfg = fbank.FbankConfig()
    np.testing.assert_array_equal(fbank.mel_banks(cfg), jfbank.mel_banks(jfbank.FbankConfig()))
    np.testing.assert_array_equal(fbank.povey_window(400), jfbank.povey_window(400))
    for n in (0, 399, 400, 560, 16000):
        assert fbank.num_frames(n, cfg) == jfbank.num_frames(n, jfbank.FbankConfig())


@pytest.mark.parametrize("standardize", [True, False])
def test_batched_fbank_matches_jax(standardize):
    rng = np.random.default_rng(0)
    lens = np.asarray([17000, 7123, 300, 0], np.int32)  # one below a window, one empty
    waves = np.zeros((4, 17000), np.float32)
    for i, n in enumerate(lens):
        waves[i, :n] = (np.sin(np.arange(n) * 0.05) * 0.2 + rng.standard_normal(n) * 0.05)
    cfg = fbank.FbankConfig(standardize=standardize)
    max_frames = fbank.num_frames(17000, cfg)
    got, got_lens = fbank.batched_fbank(torch.from_numpy(waves), torch.from_numpy(lens),
                                        max_frames, cfg)
    want, want_lens = jfbank.batched_fbank(jnp.asarray(waves), jnp.asarray(lens), max_frames,
                                           jfbank.FbankConfig(standardize=standardize))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert got.dtype == torch.float32 and got.shape == (4, max_frames, 80)
    want = np.asarray(want)
    if standardize:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    else:  # raw log energies, up to ~25: a relative bound
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


# -- the attention pooler's decoder stack --------------------------------------------------------


@pytest.mark.parametrize("norm_order", ["post", "pre"])
def test_decoder_stack_matches_jax(norm_order):
    spec = jtr.AttentionSpec(128, 2)
    layers = [jtr.init_decoder_layer(r, spec, spec, 256)
              for r in jax.random.split(jax.random.PRNGKey(3), 2)]
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *layers)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 128)).astype(np.float32)
    memory = rng.standard_normal((3, 20, 128)).astype(np.float32)
    lens = np.asarray([20, 7, 13], np.int32)
    pbias = masks.additive_bias(masks.length_mask(torch.from_numpy(lens), 20))[:, None, None, :]
    jbias = jmasks.additive_bias(jmasks.length_mask(jnp.asarray(lens), 20))[:, None, None, :]
    got = transformer.decoder_stack(
        jax.tree_util.tree_map(torch.from_numpy, stacked), torch.from_numpy(x), None,
        torch.from_numpy(memory), pbias, 2, "relu", norm_order=norm_order)
    want = jtr.decoder_stack(stacked, jnp.asarray(x), None, jnp.asarray(memory), jbias, 2,
                             "relu", norm_order=norm_order)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- the encoder and the pipeline ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(wide_params, dtype):
    """Fbank input of 200 and 300 frames: S 100 (plain path) and 150 (kernel
    path), each with a shorter row."""
    rng = np.random.default_rng(1)
    for t, lens in ((200, [200, 141]), (300, [300, 257])):
        feats = rng.standard_normal((2, t, 80)).astype(np.float32)
        flens = np.asarray(lens, np.int32)
        model = speech_encoder_from_numpy(wide_params, PORT_CFG, DT[dtype][0])
        with torch.inference_mode():
            got = model(torch.from_numpy(feats), torch.from_numpy(flens))
        jmodel = JaxSpeechEncoder(JAX_CFG, dtype=DT[dtype][1])
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, DT[dtype][1]), wide_params)
        want = jax.jit(jmodel.apply)(jparams, jnp.asarray(feats), jnp.asarray(flens))
        np.testing.assert_array_equal(got.seq_lens.numpy(), np.asarray(want.seq_lens))
        emb, jemb = _np(got.sentence_embeddings), np.asarray(want.sentence_embeddings, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(emb, jemb, atol=1e-4)
        else:
            assert _row_cos(emb, jemb).min() >= 0.999


@pytest.mark.parametrize("quantize", [False, True])
def test_encoder_builds_wr_heads_at_load(wide_params, quantize, monkeypatch):
    """The kernel's per-head r_proj of every layer is built from the layer's
    r_proj (which int8 quantisation leaves in floating point) each time the
    kernel path runs; the model's tree holds no copy that could go stale."""
    model = speech_encoder_from_numpy(wide_params, PORT_CFG, torch.bfloat16)
    runtime = speech.TorchSpeechEncoder(model, quantize=quantize, device="cpu")
    sdpa = runtime.model.params.tree()["encoder"]["layers"]["self_attn"]["sdpa"]
    assert "wr_heads" not in sdpa
    seen = []
    kernel = relpos_flash.relpos_flash_attention_v2
    monkeypatch.setattr(relpos_flash, "relpos_flash_attention_v2",
                        lambda q, k, v, wrh, *rest: seen.append(wrh) or kernel(q, k, v, wrh, *rest))
    fbank = torch.randn(1, 300, 80, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        runtime.model(fbank, torch.tensor([300]))
    r_proj = wide_params["encoder"]["layers"]["self_attn"]["sdpa"]["r_proj"]["kernel"]
    want = conformer.relpos_heads(torch.tensor(np.array(r_proj)).to(torch.bfloat16), 2)
    assert len(seen) == 2 and all(w.shape == (2, 128, 64) for w in seen)
    assert all(torch.equal(w, want[i]) for i, w in enumerate(seen))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_matches_jax(wide_params, dtype):
    """Unsorted ragged clips on both sides of the gate, in two batches of 3
    clips, each padded with a row of length 0: 1, 1.5 and 2 s (S 99, the
    plain path), then 3, 4.2 and 5 s (S 249, the kernel path); input order
    restored."""
    clips = _clips([3.0, 1.5, 5.0, 2.0, 4.2, 1.0])
    calls, launches = conformer.PLAIN_CALLS, relpos_flash.LAUNCHES
    got = _port_pipeline(wide_params, dtype).predict(clips, batch_size=3)
    assert conformer.PLAIN_CALLS > calls and relpos_flash.LAUNCHES == launches  # CPU: no launch
    want = _jax_pipeline(wide_params, dtype).predict(clips, batch_size=3)
    assert got.shape == (6, 128) and got.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-4)
    else:
        assert _row_cos(got, want).min() >= 0.999
    # Order: each clip alone gives its row of the batched call.
    alone = _port_pipeline(wide_params, dtype).predict([clips[2]], batch_size=1)
    assert _row_cos(alone, got[2:3]).min() >= 0.999


def test_predict_quantized_matches_jax(wide_params):
    clips = _clips([1.5, 3.0, 2.5])
    got = _port_pipeline(wide_params, "float32", quantize=True).predict(clips, batch_size=3)
    want = _jax_pipeline(wide_params, "float32", quantize=True).predict(clips, batch_size=3)
    assert _row_cos(got, want).min() >= 0.999


def test_fbank_dtype_honoured(wide_params):
    assert speech._normalize_fbank_dtype(None) is None
    assert speech._normalize_fbank_dtype("float16") == torch.bfloat16
    assert speech._normalize_fbank_dtype(torch.float16) == torch.bfloat16
    assert speech._normalize_fbank_dtype(np.float32) == torch.float32
    with pytest.raises(ValueError):
        speech._normalize_fbank_dtype("int8")
    clips = _clips([2.0, 3.0])
    half = _port_pipeline(wide_params, "float32", fbank_dtype="float16")
    assert half.model.fbank_dtype == torch.bfloat16
    got = half.predict(clips, batch_size=2)
    full = _port_pipeline(wide_params, "float32").predict(clips, batch_size=2)
    want = _jax_pipeline(wide_params, "float32", fbank_dtype="float16").predict(clips,
                                                                               batch_size=2)
    assert not np.allclose(got, full, atol=1e-6)  # the bf16 features change the result
    assert _row_cos(got, want).min() >= 0.999


def test_non_16k_wav_is_resampled(wide_params, tmp_path):
    """A 32 kHz wav path is resampled to 16 kHz before fbank, as in JAX."""
    wave = _clips([2.0])[0]
    wave_32k = np.repeat(wave, 2)
    path = tmp_path / "hi.wav"
    write_wav(path, wave_32k, 32000)
    decoded = speech.SpeechModelPipelineInterface()._decode_audio(str(path))
    assert abs(decoded.shape[0] - 32000) <= 2
    np.testing.assert_allclose(
        decoded, jspeech.SpeechModelPipelineInterface()._decode_audio(str(path)), atol=1e-6)
    got = _port_pipeline(wide_params, "float32").predict([str(path)], batch_size=1)
    want = _jax_pipeline(wide_params, "float32").predict([str(path)], batch_size=1)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=5e-4)


def test_tsv_pipeline_matches_predict(wide_params, tmp_path):
    """``SpeechToEmbeddingPipeline`` over a TSV manifest of wav paths gives
    the embeddings ``predict`` gives for the same files."""
    clips = _clips([1.5, 3.0, 2.2])
    rows = ["id\taudio"]
    for i, wave in enumerate(clips):
        write_wav(tmp_path / f"c{i}.wav", wave)
        rows.append(f"{i}\tc{i}.wav")
    (tmp_path / "manifest.tsv").write_text("\n".join(rows) + "\n")
    enc = _port_pipeline(wide_params, "float32").model
    context = speech.SpeechInferenceParams(
        data_file=tmp_path / "manifest.tsv", audio_root_dir=tmp_path, audio_path_index=1,
        batch_size=2, n_parallel=1, n_prefetched_batches=1)
    got = np.concatenate(list(speech.SpeechToEmbeddingPipeline(enc).build_pipeline(context)))
    want = speech.SpeechToEmbeddingModelPipeline(enc).predict(
        [str(tmp_path / f"c{i}.wav") for i in range(3)], batch_size=2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_predict_empty_and_warmup(wide_params):
    pipe = _port_pipeline(wide_params, "float32")
    assert pipe.predict([]).shape == (0, 128)
    assert pipe.warmup(batch_size=1, max_wave_len=24000) == 2  # the 1 s and 1.5 s buckets


# -- the weight bridge ---------------------------------------------------------------------


def _fairseq1_speech_state(rng):
    """A synthetic fairseq1 w2v-BERT speech checkpoint of the toy arch."""
    d, f, k, n_layers, mel = 32, 64, 7, 2, 8

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    state = {
        "encoder.w2v_model.mask_emb": t(d),
        "encoder.w2v_model.layer_norm.weight": t(mel * 2),
        "encoder.w2v_model.layer_norm.bias": t(mel * 2),
        "encoder.w2v_model.post_extract_proj.weight": t(d, mel * 2),
        "encoder.w2v_model.post_extract_proj.bias": t(d),
        "encoder.w2v_model.encoder.layer_norm.weight": t(d),
        "encoder.w2v_model.encoder.layer_norm.bias": t(d),
        "decoder.embed_tokens.weight": t(d, d),
        "decoder.embed_out": t(d, d),
    }
    for i in range(n_layers):
        p = f"encoder.w2v_model.encoder.layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            state.update({
                f"{p}.{ffn}.layer_norm.weight": t(d), f"{p}.{ffn}.layer_norm.bias": t(d),
                f"{p}.{ffn}.w_1.weight": t(f, d), f"{p}.{ffn}.w_1.bias": t(f),
                f"{p}.{ffn}.w_2.weight": t(d, f), f"{p}.{ffn}.w_2.bias": t(d),
            })
        state[f"{p}.self_attn_layer_norm.weight"] = t(d)
        state[f"{p}.self_attn_layer_norm.bias"] = t(d)
        for proj in ("linear_q", "linear_k", "linear_v", "linear_out"):
            state[f"{p}.self_attn.{proj}.weight"] = t(d, d) * 0.2
            state[f"{p}.self_attn.{proj}.bias"] = t(d)
        state[f"{p}.self_attn.linear_pos.weight"] = t(d, d) * 0.2
        state[f"{p}.self_attn.pos_bias_u"] = t(4, d // 4)
        state[f"{p}.self_attn.pos_bias_v"] = t(4, d // 4)
        state[f"{p}.conv_module.layer_norm.weight"] = t(d)
        state[f"{p}.conv_module.layer_norm.bias"] = t(d)
        state[f"{p}.conv_module.pointwise_conv1.weight"] = t(2 * d, d, 1) * 0.2
        state[f"{p}.conv_module.depthwise_conv.weight"] = t(d, 1, k)
        state[f"{p}.conv_module.batch_norm.weight"] = t(d)
        state[f"{p}.conv_module.batch_norm.bias"] = t(d)
        state[f"{p}.conv_module.batch_norm.running_mean"] = t(d)
        state[f"{p}.conv_module.batch_norm.running_var"] = np.abs(t(d)) + 0.5
        state[f"{p}.conv_module.batch_norm.num_batches_tracked"] = np.asarray(7)
        state[f"{p}.conv_module.pointwise_conv2.weight"] = t(d, d, 1) * 0.2
        state[f"{p}.final_layer_norm.weight"] = t(d)
        state[f"{p}.final_layer_norm.bias"] = t(d)
    for i in range(2):
        p = f"decoder.layers.{i}"
        for attn in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                state[f"{p}.{attn}.{proj}.weight"] = t(d, d) * 0.2
                state[f"{p}.{attn}.{proj}.bias"] = t(d)
            state[f"{p}.{attn}_layer_norm.weight"] = t(d)
            state[f"{p}.{attn}_layer_norm.bias"] = t(d)
        state.update({
            f"{p}.fc1.weight": t(f, d) * 0.2, f"{p}.fc1.bias": t(f),
            f"{p}.fc2.weight": t(d, f) * 0.2, f"{p}.fc2.bias": t(d),
            f"{p}.final_layer_norm.weight": t(d), f"{p}.final_layer_norm.bias": t(d),
        })
    return state


def test_checkpoint_bridge_matches_jax(tmp_path):
    state = _fairseq1_speech_state(np.random.default_rng(7))
    want = speech_encoder_params(dict(state))
    got = speech_encoder_params_from_state(dict(state))
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert {jax.tree_util.keystr(p) for p, _ in flat_got} == {
        jax.tree_util.keystr(p) for p in flat_want}
    for path, leaf in flat_got:
        np.testing.assert_array_equal(leaf, np.asarray(flat_want[path]))

    path = tmp_path / "speech.pt"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}}, path)
    cfg = sonar_speech_encoder_archs.get("toy")
    model = load_speech_encoder_checkpoint(path, cfg)
    feats = np.random.default_rng(8).standard_normal((2, 24, 8)).astype(np.float32)
    flens = np.asarray([24, 17], np.int32)
    with torch.inference_mode():
        got_emb = model(torch.from_numpy(feats), torch.from_numpy(flens)).sentence_embeddings
    jmodel = JaxSpeechEncoder(jcfg.sonar_speech_encoder_archs.get("toy"))
    want_emb = jmodel.apply(want, jnp.asarray(feats), jnp.asarray(flens)).sentence_embeddings
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb), atol=1e-4)

    # The same checkpoint behind a model card, through both hubs.
    from sonar_tpu.assets import hub as jax_hub
    from sonar_tpu.assets.store import ModelCard, default_store
    from sonar_tpu_torch.assets import hub
    from sonar_tpu_torch.assets import store as port_store

    name = "torch_port_speech_test_card"
    store, pstore = default_store(), port_store.default_store()
    store.register_model(ModelCard(name=name, family="sonar_speech_encoder", arch="toy",
                                   checkpoint=str(path)))
    pstore.register_model(port_store.ModelCard(name=name, family="sonar_speech_encoder",
                                               arch="toy", checkpoint=str(path)))
    try:
        port = hub.load_speech_encoder(name, device="cpu")
        ref = jax_hub.load_speech_encoder(name)
    finally:
        del store.models[name], pstore.models[name]
    waves = _clips([1.2, 0.7])
    np.testing.assert_allclose(port.encode_waveforms(waves),
                               np.asarray(ref.encode_waveforms(waves)), atol=5e-4)


def test_numpy_init_has_the_jax_layout():
    cfg = sonar_speech_encoder_archs.get("toy")
    got = init_speech_encoder_params(cfg, seed=0)
    want = JaxSpeechEncoder(jcfg.sonar_speech_encoder_archs.get("toy")).init_params(
        jax.random.PRNGKey(0))
    shapes = {jax.tree_util.keystr(p): np.shape(x)
              for p, x in jax.tree_util.tree_flatten_with_path(got)[0]}
    want_shapes = {jax.tree_util.keystr(p): np.shape(x)
                   for p, x in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert shapes == want_shapes


# -- no JAX ----------------------------------------------------------------------------


def test_speech_port_runs_without_jax():
    """A fresh interpreter in which ``import jax`` fails imports the port's
    speech pipeline and runs a toy predict."""
    script = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import sonar_tpu_torch
from sonar_tpu_torch.assets.convert import init_speech_encoder_params, speech_encoder_from_numpy
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
cfg = sonar_speech_encoder_archs.get("toy")
enc = sonar_tpu_torch.TorchSpeechEncoder(
    speech_encoder_from_numpy(init_speech_encoder_params(cfg, 0), cfg), quantize=True,
    device="cpu")
pipe = sonar_tpu_torch.SpeechToEmbeddingModelPipeline(enc)
rng = np.random.default_rng(0)
emb = pipe.predict([rng.standard_normal(n).astype(np.float32) * 0.1 for n in (9000, 20000, 300)])
assert emb.shape == (3, 32) and np.isfinite(emb).all()
assert not [m for m in sys.modules if m.startswith("jax") and sys.modules[m] is not None]
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
