"""The port's ``utils`` (``sonar_tpu_torch.utils.{flops,profiling}``).

- the analytic FLOP counts equal ``sonar_tpu.utils.flops``'s on the same
  shapes, exactly; ``mfu`` divides by the H100 SXM's published peaks;
- ``profiling.trace`` writes a Chrome trace holding an ``annotate`` region;
  ``Timer`` materialises outputs and aggregates its samples.
"""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sonar_tpu.utils import flops as jax_flops  # noqa: E402
from sonar_tpu_torch.utils import flops  # noqa: E402
from sonar_tpu_torch.utils.profiling import Timer, annotate, trace  # noqa: E402


@pytest.mark.parametrize("d,f,layers,b,s", [
    (1024, 8192, 24, 64, 128), (256, 1024, 4, 4, 64), (32, 64, 2, 1, 1), (1024, 4096, 24, 8, 499),
])
def test_counts_equal_jax(d, f, layers, b, s):
    assert flops.transformer_encoder_flops(d, f, layers, b, s) == \
        jax_flops.transformer_encoder_flops(d, f, layers, b, s)
    assert flops.conformer_encoder_flops(d, f, layers, 31, b, s) == \
        jax_flops.conformer_encoder_flops(d, f, layers, 31, b, s)
    assert flops.decoder_step_flops(d, f, layers, 256206, b * 5, s / 2) == \
        jax_flops.decoder_step_flops(d, f, layers, 256206, b * 5, s / 2)


def test_mfu_uses_the_h100_peaks():
    assert flops.H100_SXM_PEAK == {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
    assert flops.mfu(989e12) == 1.0
    assert flops.mfu(1979e12 / 4, "int8") == 0.25
    assert flops.mfu(6.7e12, "fp32") == pytest.approx(0.1)
    with pytest.raises(KeyError):
        flops.mfu(1.0, "fp8")


def test_trace_writes_a_chrome_trace(tmp_path: Path):
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    with trace(str(tmp_path)) as prof:
        with annotate("unit-test-region"):
            y = (x @ x).sum()
    assert float(y) > 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "unit-test-region" for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_timer_materialises_and_aggregates():
    t = Timer()
    seen = []

    def fn(v):
        seen.append(1)
        return {"a": v + 1.0, "b": [v * 2.0, (v,)]}

    p50 = t.measure(fn, torch.ones(8), iters=5)
    assert len(seen) == 6 and len(t.samples) == 5  # one warmup call
    assert p50 > 0.0 and np.isfinite(p50)
    assert t.best <= t.p50 == sorted(t.samples)[2]


def test_timer_empty_is_nan():
    t = Timer()
    assert np.isnan(t.p50) and np.isnan(t.best)
