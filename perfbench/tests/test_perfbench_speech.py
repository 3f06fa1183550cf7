"""The speech cell (``speech.eng_mixed``) on the CPU at toy width: a traced
run reports its four per-layer metrics, each reader reads nothing where the
program records no speech spans or ``stats`` (as the parent's program
would), and four faults planted in the program read not correct."""

import functools
import time

import pytest

from perfbench.tests.conftest import ROOT, run_cell
from perfbench.harness import bench

CELL = "speech.eng_mixed"
METRICS = ["relpos_roofline.speech", "mfu.speech", "padding_waste.speech", "prep_ms.speech"]


def reader(name):
    return bench.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                             "perfbench_metric_" + name.replace(".", "_"))


def test_a_traced_run_reports_the_speech_metrics():
    """On the CPU #6 never launches (its wrapper runs the plain version), so
    its share reads nothing; the other three read."""
    line = run_cell(CELL, trace=1)
    assert line["correct"] is True, line["checks"]
    got = line["metrics"]
    assert set(got) == set(METRICS) - {"relpos_roofline.speech"}
    assert 0 < got["mfu.speech"]["value"] < 100
    assert 0 < got["padding_waste.speech"]["value"] < 100
    assert got["prep_ms.speech"]["value"] > 0


def test_the_relpos_reader_reads_a_synthetic_trace():
    """24 launches a batch of 128 <= S <= 2048 (a batch of S 99 takes the
    plain path), against the kernels' device time."""
    from types import SimpleNamespace

    from perfbench.harness import speech_work
    from sonar_tpu_torch.utils.profiling import recording, span

    model = {"num_encoder_layers": 24, "model_dim": 1024, "num_encoder_attn_heads": 16}
    with recording():
        with span("pipeline.predict"):
            for rows, s in ((16, 99), (16, 499), (8, 1999)):
                with span("runtime.enqueue", rows=rows, length=s):
                    pass
    kernels = [("void relpos_v2_rt_kernel<64>(...)", 0.0, 1e-3)] * 48 + [("other", 0.0, 1.0)]
    obs = {"model": model, "trace": SimpleNamespace(kernels=kernels),
           "traced": {"counts": {"launches.relpos": 48}}}
    least = 24 * sum(speech_work.relpos_least_s(b, 16, s, 64, 1024)
                     for b, s in ((16, 499), (8, 1999)))
    assert reader("relpos_roofline.speech").read(obs) == pytest.approx(100 * least / 0.048)
    obs["traced"]["counts"]["launches.relpos"] = 47  # the counter disagrees: nothing to read
    assert reader("relpos_roofline.speech").read(obs) is None


@pytest.mark.parametrize("name", METRICS)
def test_nothing_to_read_without_the_speech_spans_or_stats(name):
    """Observations as the parent's program gives them: a traced call whose
    recording holds only the data pipeline's spans, and counts without the
    ``stats`` keys."""
    from types import SimpleNamespace

    from sonar_tpu_torch.utils.profiling import recording, span

    with recording():
        with span("pipeline.wait", cause=None):
            time.sleep(0.001)
    obs = {"model": {"num_encoder_layers": 2, "model_dim": 128, "num_encoder_attn_heads": 2,
                     "ffn_inner_dim": 256, "depthwise_kernel_size": 31,
                     "num_fbank_channels": 80, "fbank_stride": 2, "num_decoder_layers": 3},
           "window_s": 1.0, "seconds": 0.5,
           "counts": {"launches.relpos": 0, "plain_calls": 0},
           "trace": SimpleNamespace(kernels=[], busy_s=0.1, window_s=0.2),
           "traced": {"counts": {"launches.relpos": 0, "plain_calls": 0}}}
    read = reader(name).read
    assert read(obs) is None
    assert read({}) is None and read({"trace": None}) is None


def _no_relpos(monkeypatch):
    """The positional term dropped: zero trig tables give bd = 0 on the
    kernel's path and the plain one."""
    from sonar_tpu_torch.nn import conformer

    tables = conformer._trig_tables
    monkeypatch.setattr(conformer, "_trig_tables", lambda *a: tuple(t * 0 for t in tables(*a)))


def _no_depthwise(monkeypatch):
    """The depthwise convolution skipped: its input passed through."""
    import torch

    def skip(y, w, groups):
        k = w.shape[-1]
        return y[..., (k - 1) // 2: y.shape[-1] - (k - 1 - (k - 1) // 2)]

    monkeypatch.setattr(torch.nn.functional, "conv1d", skip)


def _unstandardized(monkeypatch):
    """The fbank left unstandardised."""
    from sonar_tpu_torch.inference_pipelines import speech

    monkeypatch.setattr(speech, "FbankConfig",
                        functools.partial(speech.FbankConfig, standardize=False))


def _pool_padding(monkeypatch):
    """The pooler attending to the padded frames too."""
    import torch

    from sonar_tpu_torch.nn import pooling

    monkeypatch.setattr(pooling, "length_mask", lambda lens, s: torch.ones(
        lens.shape[0], s, dtype=torch.bool, device=lens.device))


@pytest.mark.parametrize("fault", [_no_relpos, _no_depthwise, _unstandardized, _pool_padding])
def test_a_broken_speech_encoder_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    line = run_cell(CELL)
    assert line["correct"] is False
    check = line["checks"]["emb_rel_err"]
    assert check["value"] > check["limit"]
