"""The port's ``TextToEmbeddingModelPipeline`` against ``sonar_tpu``'s on a toy
encoder and the toy NLLB tokenizer, and the port's independence from JAX.

fp32 embeddings agree to atol 2e-4; int8 to cosine >= 0.999 per row.
"""

import os
from pathlib import Path
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from helpers import build_toy_nllb, build_toy_spm_proto  # noqa: E402

from sonar_tpu.inference_pipelines.text import (  # noqa: E402
    JitTextEncoder,
    TextToEmbeddingModelPipeline as JaxPipeline,
)
from sonar_tpu.models.sonar_text import SonarTextEncoder as JaxEncoder  # noqa: E402
from sonar_tpu.models.sonar_text import sonar_text_encoder_archs as jax_archs  # noqa: E402
from sonar_tpu_torch.assets.convert import text_encoder_from_numpy  # noqa: E402
from sonar_tpu_torch.inference_pipelines.text import (  # noqa: E402
    TextToEmbeddingModelPipeline,
    TorchTextEncoder,
)
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs  # noqa: E402
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
TEXTS = [
    "hello world", "my name is paul", "i work as a teacher",
    "the cat sat on the mat " * 6, "bonjour", "je suis", "the cat", "hello " * 30,
    "a", "world is my name",
]


@pytest.fixture(scope="module")
def toy():
    cfg = jax_archs.get("toy")
    params = jax.tree_util.tree_map(
        np.asarray, JaxEncoder(cfg).init_params(jax.random.PRNGKey(0)))
    return cfg, params


def _port_tokenizer(tmp_path):
    from sonar_tpu.tokenizers.spm_proto import serialize_model_proto

    path = tmp_path / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    return NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")


def test_tokenizer_matches_jax_tokenizer(tmp_path):
    port, ref = _port_tokenizer(tmp_path), build_toy_nllb(tmp_path)
    assert port.vocab_info.size == ref.vocab_info.size
    assert port.vocab_info.pad_idx == ref.vocab_info.pad_idx
    enc, ref_enc = port.create_encoder(lang="fra_Latn"), ref.create_encoder(lang="fra_Latn")
    for text in TEXTS:
        assert list(enc(text)) == list(ref_enc(text))
    with pytest.raises(ValueError):
        port.create_encoder(lang="xxx_Latn")


@pytest.mark.parametrize("batching,quantize", [
    ("dynamic", False), ("static", False), ("dynamic", True), ("static", True),
])
def test_predict_matches_jax_pipeline(toy, tmp_path, batching, quantize):
    cfg, params = toy
    model = text_encoder_from_numpy(params, sonar_text_encoder_archs.get("toy"))
    port = TextToEmbeddingModelPipeline(TorchTextEncoder(model, quantize=quantize, device="cpu"),
                                        _port_tokenizer(tmp_path))
    ref = JaxPipeline(JitTextEncoder(JaxEncoder(cfg), params, quantize=quantize),
                      build_toy_nllb(tmp_path))
    got = port.predict(TEXTS, source_lang="eng_Latn", batch_size=3, batching=batching)
    want = np.asarray(ref.predict(TEXTS, source_lang="eng_Latn", batch_size=3,
                                  batching=batching), np.float32)
    assert got.shape == (len(TEXTS), 32) and got.dtype == np.float32
    if quantize:
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        assert cos.min() >= 0.999
    else:
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_predict_options_and_stats(toy, tmp_path):
    cfg, params = toy
    enc = TorchTextEncoder(text_encoder_from_numpy(params, sonar_text_encoder_archs.get("toy")),
                           device="cpu")
    pipe = TextToEmbeddingModelPipeline(enc, _port_tokenizer(tmp_path))
    assert pipe.predict([], source_lang="eng_Latn").shape == (0, 32)
    with pytest.raises(ValueError):
        pipe.predict(TEXTS, source_lang="eng_Latn", batching="packed")
    with pytest.raises(ValueError):
        pipe.predict(TEXTS, source_lang="eng_Latn", batch_size=None)
    with pytest.warns(UserWarning, match="truncated"):
        short = pipe.predict(TEXTS, source_lang="eng_Latn", max_seq_len=6)
    assert short.shape == (len(TEXTS), 32)
    alone = pipe.predict(TEXTS[3:4], source_lang="eng_Latn")
    batched = pipe.predict(TEXTS, source_lang="eng_Latn", batch_max_tokens=50, batch_size=None)
    np.testing.assert_allclose(batched[3:4], alone, atol=2e-5)
    snap = enc.stats.snapshot()
    assert snap["batches"] > 0 and 0.0 <= snap["padding_waste"] < 1.0
    assert enc.warmup(len_buckets=(8, 16), tokens_per_batch=64) == 2


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter imports the port and runs a toy predict without
    ever importing jax (the GPU machine has none)."""
    script = f"""
import sys
from pathlib import Path
sys.path.insert(0, {str(REPO / 'tests')!r})
import numpy as np, torch
from sonar_tpu.tokenizers.spm_proto import serialize_model_proto
from helpers import build_toy_spm_proto
from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
from sonar_tpu_torch.inference_pipelines.text import TextToEmbeddingModelPipeline, TorchTextEncoder
from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs
from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
path = Path({str(tmp_path)!r}) / "t.model"
path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
tok = NllbTokenizer(path, langs=["eng_Latn"])
cfg = sonar_text_encoder_archs.get("toy")
enc = TorchTextEncoder(text_encoder_from_numpy(init_text_encoder_params(cfg, 0), cfg), quantize=True, device="cpu")
emb = TextToEmbeddingModelPipeline(enc, tok).predict(["hello world", "the cat"], source_lang="eng_Latn", batching="static")
assert emb.shape == (2, 32) and np.isfinite(emb).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
