"""The port's speech -> text pipelines against ``sonar_tpu``'s on CPU.

The speech encoder is the D 128 config of ``test_torch_port_speech.py``
(2 heads of 64, 2 Conformer layers: clips of S >= 128 reach the rel-pos
kernel's plain version); the decoder is a D 128 decoder of 2 heads of 64
over the toy NLLB vocabulary. Inputs: the committed ``tests/data/tone.flac``
and synthetic 16 kHz waves on both sides of the kernel gate. Everything in
fp32, weights from JAX seeds given to both packages; the decoded token ids,
and so the strings, must be identical.
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

from sonar_tpu.data.audio import write_wav  # noqa: E402
from sonar_tpu.generation.beam_search import BeamSearchConfig as JaxBeamConfig  # noqa: E402
from sonar_tpu.generation.decoder_runtime import JitTextDecoder  # noqa: E402
from sonar_tpu.inference_pipelines import speech as jspeech  # noqa: E402
from sonar_tpu.models.sonar_speech import config as jcfg  # noqa: E402
from sonar_tpu.models.sonar_speech.model import SonarSpeechEncoder as JaxSpeechEncoder  # noqa: E402
from sonar_tpu.models.sonar_text.config import sonar_text_decoder_archs as jax_dec_archs  # noqa: E402
from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder as JaxDecoder  # noqa: E402
from sonar_tpu.nn.conformer import ConformerConfig as JaxConformerConfig  # noqa: E402
from sonar_tpu_torch.assets.convert import (  # noqa: E402
    speech_encoder_from_numpy,
    text_decoder_from_numpy,
)
from sonar_tpu_torch.generation.beam_search import BeamSearchConfig  # noqa: E402
from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder  # noqa: E402
from sonar_tpu_torch.inference_pipelines import speech  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs  # noqa: E402
from sonar_tpu_torch.nn import conformer  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402

DATA = Path(__file__).resolve().parents[1] / "data"


def _speech_cfg(archs, conformer_cfg):
    base = archs.get("toy")
    return dataclasses.replace(
        base,
        conformer=conformer_cfg(model_dim=128, num_layers=2, num_heads=2, ffn_inner_dim=256,
                                depthwise_kernel_size=7),
        frontend=dataclasses.replace(base.frontend, num_fbank_channels=80, model_dim=128),
        model_dim=128, num_decoder_attn_heads=2, ffn_inner_dim=256,
    )


def _decoder_cfg(archs, vocab_size):
    toy = archs.get("toy")
    return dataclasses.replace(
        toy, model_dim=128, num_encoder_attn_heads=2, num_decoder_attn_heads=2,
        ffn_inner_dim=256, vocab_info=dataclasses.replace(toy.vocab_info, size=vocab_size))


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(JAX speech encoder, JAX decoder, JAX tokenizer, port encoder, port
    decoder, port tokenizer), the same weights on both sides."""
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    tmp = tmp_path_factory.mktemp("s2t")
    path = tmp / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    tok = NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")
    jtok = build_toy_nllb(tmp)
    scfg = _speech_cfg(jcfg.sonar_speech_encoder_archs, JaxConformerConfig)
    sparams = jax.tree_util.tree_map(np.asarray, JaxSpeechEncoder(scfg).init_params(
        jax.random.PRNGKey(0)))
    dcfg = _decoder_cfg(jax_dec_archs, tok.vocab_info.size)
    # A seed whose random decoder writes words, not only control tokens.
    dparams = jax.tree_util.tree_map(np.asarray, JaxDecoder(dcfg).init_params(
        jax.random.PRNGKey(4)))
    jenc = jspeech.JitSpeechEncoder(JaxSpeechEncoder(scfg), sparams)
    jdec = JitTextDecoder(JaxDecoder(dcfg), dparams, quantize=False)
    tenc = speech.TorchSpeechEncoder(speech_encoder_from_numpy(
        sparams, _speech_cfg(sonar_speech_encoder_archs, conformer.ConformerConfig)),
        device="cpu")
    tdec = TorchTextDecoder(text_decoder_from_numpy(
        dparams, _decoder_cfg(sonar_text_decoder_archs, tok.vocab_info.size)), device="cpu")
    return jenc, jdec, jtok, tenc, tdec, tok


def _clips(seconds, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for sec in seconds:
        n = int(sec * 16000)
        t = np.arange(n) / 16000.0
        tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t)
        out.append((tone + 0.05 * rng.standard_normal(n)).astype(np.float32))
    return out


GEN = dict(beam_size=3, max_gen_len=8)


def test_model_pipeline_matches_jax(bundle):
    """Waves of 1.5, 3.2 and 2 s plus the committed flac, in batches of 3
    (S 74-159: both sides of the kernel gate): the same strings, and the
    same beam tokens for the same embeddings."""
    jenc, jdec, jtok, tenc, tdec, tok = bundle
    inputs = _clips([1.5, 3.2, 2.0]) + [str(DATA / "tone.flac")]
    calls = conformer.PLAIN_CALLS
    got = speech.SpeechToTextModelPipeline(tenc, tdec, tok, device="cpu").predict(
        inputs, target_lang="fra_Latn", batch_size=3, **GEN)
    assert conformer.PLAIN_CALLS > calls
    want = jspeech.SpeechToTextModelPipeline(jenc, jdec, jtok).predict(
        inputs, target_lang="fra_Latn", batch_size=3, **GEN)
    assert len(got) == 4 and got == want and any(got)

    waves = _clips([1.5, 3.2, 2.0])
    emb = tenc.encode_waveforms(waves, materialize=False)
    assert torch.is_tensor(emb) and emb.shape == (3, 128)
    prefix = tok.create_encoder(lang="fra_Latn", mode="target").prefix_indices
    tt, ts, tl = tdec.generate_beam(emb.float()[:, None, :], prefix, BeamSearchConfig(**GEN))
    jt, js, jl = jdec.generate_beam(np.asarray(jenc.encode_waveforms(waves))[:, None, :],
                                    prefix, JaxBeamConfig(**GEN))
    np.testing.assert_array_equal(tl, jl)
    for r in range(3):
        assert tt[r, 0, : tl[r, 0]].tolist() == jt[r, 0, : jl[r, 0]].tolist()


def test_tsv_pipeline_matches_jax(bundle, tmp_path):
    """``SpeechToTextPipeline`` over a TSV manifest of wav paths and the
    flac fixture: the JAX pipeline's strings, batch by batch."""
    jenc, jdec, jtok, tenc, tdec, tok = bundle
    rows = ["id\taudio"]
    for i, wave in enumerate(_clips([2.5, 1.2], seed=7)):
        write_wav(tmp_path / f"c{i}.wav", wave)
        rows.append(f"{i}\tc{i}.wav")
    rows.append(f"2\t{DATA / 'tone.flac'}")
    (tmp_path / "manifest.tsv").write_text("\n".join(rows) + "\n")
    kw = dict(data_file=tmp_path / "manifest.tsv", audio_root_dir=tmp_path, audio_path_index=1,
              batch_size=2, target_lang="eng_Latn", n_parallel=1, n_prefetched_batches=1)
    got = list(speech.SpeechToTextPipeline((tenc, tdec), tok, device="cpu").build_pipeline(
        speech.SpeechInferenceParams(**kw)))
    want = list(jspeech.SpeechToTextPipeline((jenc, jdec), jtok).build_pipeline(
        jspeech.SpeechInferenceParams(**kw)))
    assert [len(b) for b in got] == [2, 1] and got == want
    with pytest.raises(ValueError, match="target_lang"):
        speech.SpeechToTextPipeline((tenc, tdec), tok).prebuild_pipeline(
            speech.SpeechInferenceParams(**dict(kw, target_lang=None)))


def test_unknown_generator_kwargs_raise(bundle):
    """Unknown generator kwargs raise as in the beam pipelines."""
    _, _, _, tenc, tdec, tok = bundle
    pipe = speech.SpeechToTextModelPipeline(tenc, tdec, tok, device="cpu")
    with pytest.raises(TypeError):
        pipe.predict(_clips([1.0]), target_lang="eng_Latn", beam_sz=2)
