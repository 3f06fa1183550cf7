"""Run phase (n) of ``chip_smoke.py`` (each path kernels-on against
kernels-off) alone.

    python3 scripts/torch_kernels_off.py

Builds the kernels, makes the inputs phase (n) takes from (d)-(f) from the
same seeds (the synthetic tokenizer, the full-width ``basic`` encoder in
int8 and bf16, the ``english`` speech encoder in bf16 and the ``basic``
decoder in fp32, all on the card) without running those phases, and runs
(n): each path's launches with and without ``no_cuda_kernels()``, its
agreement and its device ms both ways, in about two minutes with the build
(the whole script takes about eleven). The decodes read 32 random
embeddings at the scale of the encoder's (std 0.05), not (d)'s. Prints the
card's name and power limit first; exits non-zero when a check fails.
"""

from pathlib import Path
import sys
import time
import types

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np

    torch, card = cs.setup()
    cs.build()
    from sonar_tpu_torch.assets.convert import (
        init_speech_encoder_params,
        init_text_decoder_params,
        init_text_encoder_params,
        speech_encoder_from_numpy,
        text_decoder_from_numpy,
        text_encoder_from_numpy,
    )
    from sonar_tpu_torch.inference_pipelines.speech import TorchSpeechEncoder
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tmp = REPO / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    tokenizer, _ = cs._tokenizer(tmp, rng)
    ecfg = sonar_text_encoder_archs.get("basic")
    text_params = init_text_encoder_params(ecfg, seed=0)
    text = {mode: types.SimpleNamespace(model=TorchTextEncoder(
        text_encoder_from_numpy(text_params, ecfg, torch.bfloat16, cs.DEVICE), quantize=quantize))
        for mode, quantize in (("int8", True), ("bf16", False))}
    scfg = sonar_speech_encoder_archs.get("english")
    speech = TorchSpeechEncoder(speech_encoder_from_numpy(
        init_speech_encoder_params(scfg, seed=0), scfg, torch.bfloat16, cs.DEVICE))
    dcfg = sonar_text_decoder_archs.get("basic")
    decoder = text_decoder_from_numpy(init_text_decoder_params(dcfg, seed=0), dcfg,
                                      torch.float32, cs.DEVICE)
    handoff = {"text_pipelines": text, "text_params": text_params, "tokenizer": tokenizer,
               "embeddings": (rng.normal(size=(64, ecfg.model_dim)) * 0.05).astype(np.float32),
               "speech_pipelines": {"bf16": types.SimpleNamespace(model=speech)},
               "decoders": {"fp32": types.SimpleNamespace(model=decoder)}}
    cs.log(f"inputs of (n) made in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.run_kernels_off(torch, card, handoff)
    cs.log(f"phase (n) took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
