"""The port's speech -> embedding path against the benchmark's plain
reference (``perfbench/reference/speech_encoder.py``: its own Kaldi fbank and
the published rel-shift form of relative attention, fp32, one clip at a
time), on the CPU, on weights drawn by the benchmark's drawer
(``perfbench/harness/weights_speech.py``: every LayerNorm, the BatchNorm's
statistics, u / v biases drawn).

The config is ``test_torch_port_speech.py``'s: D 128, 2 heads of 64, FFN 256,
2 Conformer layers, depthwise kernel 7, 80 mel bins, a 2-layer pooler. One
``predict(batch_size=3)`` of five clips takes both rel-pos paths: the three
shortest pad to the 2.5-s bucket (S 124: ``rel_pos_attend_plain``) in a
batch of 4 rows (one a padding row), the other two to the 6-s bucket (S 299:
the v2 kernel's wrapper, whose plain version runs on CPU tensors).

Tolerances:
- fp32: ||port - reference|| / ||reference|| <= 2e-4 a clip (read 8e-6 to
  2.2e-5): the two fbanks differ in their FFTs and in float64 against fp32
  framing, which the log amplifies in quiet bins; the trig factorisation
  against the rel-shift and the products' order add little. Each planted
  fault reads 0.02 or more, a hundred times the tolerance.
- bf16 (the port computing in bf16 on bf16 weights, the reference in fp32
  on the same values): cosine >= 0.999 a clip (read >= 0.9999; relative
  error 0.007-0.010 from bf16 roundings through two layers).
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import weights_speech  # noqa: E402
from perfbench.reference import speech_encoder as ref  # noqa: E402
from perfbench.systems import speech_encoder as system  # noqa: E402
from sonar_tpu_torch.inference_pipelines import speech  # noqa: E402
from sonar_tpu_torch.nn import conformer, pooling  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
CFG = {"model_dim": 128, "num_encoder_layers": 2, "num_encoder_attn_heads": 2,
       "ffn_inner_dim": 256, "depthwise_kernel_size": 7, "num_fbank_channels": 80,
       "fbank_stride": 2, "num_decoder_layers": 2, "num_decoder_attn_heads": 2,
       "pooler_ffn_inner_dim": 256, "max_seq_len": 1024, "bos_idx": 2}
SECONDS = [1.3, 5.2, 1.8, 3.1, 2.2]


def _clips(seconds, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for s in seconds:
        t = np.arange(int(s * 16000)) / 16000.0
        wave = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 800) * t)
        out.append((wave + 0.05 * rng.standard_normal(t.shape[0])).astype(np.float32))
    return out


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _pipeline(tree, dtype):
    runtime = {"dtype": dtype, "quantize": False, "fbank_dtype": None}
    return system.build(torch, {"model": CFG, "runtime": runtime}, tree, "cpu")[0]


@pytest.fixture(scope="module")
def tree():
    return weights_speech.speech_encoder(torch, CFG, 7, torch.float32, torch.device("cpu"))


@pytest.fixture(scope="module")
def waves():
    return _clips(SECONDS)


@pytest.fixture(scope="module")
def want(tree, waves):
    return ref.embed(tree, CFG, waves, quant="bf16")


def _rel_err(got, want):
    got = torch.as_tensor(got).float()
    return ((got - want).norm(dim=1) / want.norm(dim=1)).numpy()


def test_fp32_port_matches_the_reference_on_both_paths(tree, waves, want):
    pipe = _pipeline(tree, "float32")
    plain = conformer.PLAIN_CALLS
    got = pipe.predict(waves, batch_size=3)
    # the S-124 batch takes the plain path in each layer, the S-299 one the kernel's
    assert conformer.PLAIN_CALLS - plain == CFG["num_encoder_layers"]
    assert got.shape == (len(waves), CFG["model_dim"])
    assert _rel_err(got, want).max() <= 2e-4


def test_bf16_port_matches_the_reference_by_cosine(tree, waves):
    tree16 = _cast(tree, torch.bfloat16)
    want = ref.embed(tree16, CFG, waves, quant="bf16")
    got = torch.as_tensor(_pipeline(tree16, "bfloat16").predict(waves, batch_size=3))
    assert torch.nn.functional.cosine_similarity(got, want).min() >= 0.999


@pytest.mark.parametrize("s", [1, 2, 5, 16])
def test_the_rel_shift_is_the_score_against_distance_i_minus_j(s):
    """In float64: the rel-shift of (q + v) r^T equals (q_i + v) . r(i - j)
    computed pair by pair, with r(d) the table's row for distance d."""
    g = torch.Generator().manual_seed(s)
    h, dh, d = 2, 4, 8
    qv = torch.randn(h, s, dh, generator=g, dtype=torch.float64)
    r = torch.randn(h, 2 * s - 1, dh, generator=g, dtype=torch.float64)  # rows: S-1 .. -(S-1)
    got = ref.rel_shift(qv @ r.transpose(1, 2))
    loop = torch.empty(h, s, s, dtype=torch.float64)
    for i in range(s):
        for j in range(s):
            loop[:, i, j] = (qv[:, i] * r[:, (s - 1) - (i - j)]).sum(-1)
    assert torch.allclose(got, loop, rtol=0, atol=1e-12)
    table = ref.rel_table(s, d, "cpu").double()
    freq = torch.exp(torch.arange(0, d, 2, dtype=torch.float64) * (-np.log(10000.0) / d))
    for dist in range(-(s - 1), s):
        row = table[(s - 1) - dist]
        assert torch.allclose(row[0::2], torch.sin(dist * freq), atol=1e-6)
        assert torch.allclose(row[1::2], torch.cos(dist * freq), atol=1e-6)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    names = set()
    for name in ("speech_encoder.py", "text_encoder.py"):
        tree = ast.parse((REPO / "perfbench" / "reference" / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "math", "typing", "torch", "perfbench"}


def _no_relpos(monkeypatch):
    tables = conformer._trig_tables
    monkeypatch.setattr(conformer, "_trig_tables", lambda *a: tuple(t * 0 for t in tables(*a)))


def _no_depthwise(monkeypatch):
    def skip(y, w, groups):
        k = w.shape[-1]
        return y[..., (k - 1) // 2: y.shape[-1] - (k - 1 - (k - 1) // 2)]

    monkeypatch.setattr(torch.nn.functional, "conv1d", skip)


def _unstandardized(monkeypatch):
    monkeypatch.setattr(speech, "FbankConfig",
                        functools.partial(speech.FbankConfig, standardize=False))


def _pool_padding(monkeypatch):
    monkeypatch.setattr(pooling, "length_mask", lambda lens, s: torch.ones(
        lens.shape[0], s, dtype=torch.bool, device=lens.device))


@pytest.mark.parametrize("fault", [_no_relpos, _no_depthwise, _unstandardized, _pool_padding])
def test_a_planted_fault_fails_the_fp32_comparison(tree, waves, want, fault, monkeypatch):
    """The positional term dropped, the depthwise convolution skipped, the
    fbank left unstandardised, the pooler attending to padded frames."""
    fault(monkeypatch)
    got = _pipeline(tree, "float32").predict(waves, batch_size=3)
    assert _rel_err(got, want).max() > 100 * 2e-4
