"""Toy models bound in both packages on the same numpy weights, for the
port's serving, client and HuggingFace tests.

``build_toys`` draws one toy text encoder, text decoder (over the toy NLLB
tokenizer's vocabulary) and speech encoder; ``jax_pipelines`` and
``port_pipelines`` bind them as each package's ``/embed``, ``/translate``
and ``/embed_speech`` pipelines (the port's on the CPU).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict

import jax
import numpy as np

from helpers import build_toy_nllb, build_toy_spm_proto

# The port's tolerances against the JAX package, as its pipeline tests hold
# them: fp32 text embeddings atol 2e-4, fp32 speech embeddings atol 5e-4.
TEXT_ATOL = 2e-4
SPEECH_ATOL = 5e-4


@dataclasses.dataclass
class Toys:
    jax_tokenizer: Any
    port_tokenizer: Any
    jax_encoder: tuple       # (SonarTextEncoder, params) of sonar_tpu
    port_encoder: Any        # sonar_tpu_torch SonarTextEncoder
    jax_decoder: tuple
    port_decoder: Any
    jax_speech: Any          # sonar_tpu JitSpeechEncoder
    port_speech: Any         # sonar_tpu_torch SonarSpeechEncoder


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def build_toys(tmp_path: Path) -> Toys:
    from sonar_tpu.inference_pipelines.speech import JitSpeechEncoder
    from sonar_tpu.models.sonar_speech import SonarSpeechEncoder, sonar_speech_encoder_archs
    from sonar_tpu.models.sonar_text import (
        SonarTextEncoder,
        sonar_text_decoder_archs,
        sonar_text_encoder_archs,
    )
    from sonar_tpu.nn.conditional_decoder import ConditionalTransformerDecoder
    from sonar_tpu.ops.fbank import FbankConfig
    from sonar_tpu_torch.assets import convert
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs as port_speech
    from sonar_tpu_torch.models.sonar_text import (
        sonar_text_decoder_archs as port_dec,
        sonar_text_encoder_archs as port_enc,
    )
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    jax_tok = build_toy_nllb(tmp_path)
    path = tmp_path / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    port_tok = NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")
    size = jax_tok.vocab_info.size

    def sized(cfg):
        return dataclasses.replace(cfg, vocab_info=dataclasses.replace(cfg.vocab_info, size=size))

    ecfg = sized(sonar_text_encoder_archs.get("toy"))
    enc = SonarTextEncoder(ecfg)
    eparams = _np_tree(enc.init_params(jax.random.PRNGKey(0)))
    dcfg = sized(sonar_text_decoder_archs.get("toy"))
    dec = ConditionalTransformerDecoder(dcfg)
    dparams = _np_tree(dec.init_params(jax.random.PRNGKey(1)))
    scfg = sonar_speech_encoder_archs.get("toy")
    smodel = SonarSpeechEncoder(scfg)
    sparams = _np_tree(smodel.init_params(jax.random.PRNGKey(2)))
    return Toys(
        jax_tokenizer=jax_tok,
        port_tokenizer=port_tok,
        jax_encoder=(enc, eparams),
        port_encoder=convert.text_encoder_from_numpy(eparams, sized(port_enc.get("toy"))),
        jax_decoder=(dec, dparams),
        port_decoder=convert.text_decoder_from_numpy(dparams, sized(port_dec.get("toy"))),
        jax_speech=JitSpeechEncoder(smodel, sparams, fbank_config=FbankConfig(num_mel_bins=8)),
        port_speech=convert.speech_encoder_from_numpy(sparams, port_speech.get("toy")),
    )


def jax_pipelines(toys: Toys) -> Dict[str, Any]:
    from sonar_tpu.inference_pipelines.speech import SpeechToEmbeddingModelPipeline
    from sonar_tpu.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TextToTextModelPipeline,
    )

    return {
        "embed": TextToEmbeddingModelPipeline(encoder=toys.jax_encoder,
                                              tokenizer=toys.jax_tokenizer),
        "translate": TextToTextModelPipeline(encoder=toys.jax_encoder, decoder=toys.jax_decoder,
                                             tokenizer=toys.jax_tokenizer, quantize=False),
        "embed_speech": SpeechToEmbeddingModelPipeline(encoder=toys.jax_speech),
    }


def port_pipelines(toys: Toys, device: str = "cpu") -> Dict[str, Any]:
    """The port's three pipelines, each an object of its own (one per
    endpoint, as the server wants them)."""
    from sonar_tpu_torch.inference_pipelines.speech import SpeechToEmbeddingModelPipeline
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TextToTextModelPipeline,
    )

    return {
        "embed": TextToEmbeddingModelPipeline(toys.port_encoder, toys.port_tokenizer,
                                              device=device),
        "translate": TextToTextModelPipeline(toys.port_encoder, toys.port_decoder,
                                             toys.port_tokenizer, device=device),
        "embed_speech": SpeechToEmbeddingModelPipeline(toys.port_speech, device=device),
    }


def waves(seed: int = 0, lengths=(6000, 9000)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lengths]
