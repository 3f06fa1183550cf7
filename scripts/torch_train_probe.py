"""Run phase (k) of ``chip_smoke.py`` (training on the card) alone.

    python3 scripts/torch_train_probe.py

Builds the kernels, makes the inputs phase (k) takes from (d)-(f) from the
same seeds (the synthetic tokenizer and corpus, the full-width ``basic``
encoder and decoder and ``english`` speech encoder weights, a fused bf16
``basic`` encoder on the card for (k3)) without running those phases, and
runs (k1)-(k4): a quick check of the training path on the card (about two
minutes with the build, against the whole script's eight). The teachers of
(k2) are 64 random embeddings at the scale of the encoder's (std 0.05), not
(d)'s, so (k2)'s losses differ from the whole script's. Prints the card's
name and power limit first; exits non-zero when a check fails.
"""

from pathlib import Path
import sys
import time

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import numpy as np

    torch, card = cs.setup()
    cs.build()
    from sonar_tpu_torch.assets.convert import (
        init_speech_encoder_params, init_text_decoder_params, init_text_encoder_params,
        text_encoder_from_numpy)
    from sonar_tpu_torch.inference_pipelines.text import TorchTextEncoder
    from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs, sonar_text_encoder_archs

    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    tmp = REPO / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    tokenizer, words = cs._tokenizer(tmp, rng)
    cfg = sonar_text_encoder_archs.get("basic")
    text_params = init_text_encoder_params(cfg, seed=0)
    handoff = {
        "tokenizer": tokenizer,
        "corpus": cs._corpus(rng, words, cs.N_SENTENCES),
        "text_params": text_params,
        "decoder_params": init_text_decoder_params(sonar_text_decoder_archs.get("basic"), seed=0),
        "speech_params": init_speech_encoder_params(sonar_speech_encoder_archs.get("english"),
                                                    seed=0),
        "embeddings": np.random.default_rng(1).normal(size=(64, cfg.model_dim)).astype(
            np.float32) * 0.05,
        "encoder": TorchTextEncoder(text_encoder_from_numpy(text_params, cfg, torch.bfloat16,
                                                            cs.DEVICE), fuse_qkv=True),
    }
    cs.log(f"inputs of (k) made in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cs.run_training(torch, card, handoff)
    cs.log(f"phase (k) done in {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
