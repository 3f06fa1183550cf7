"""The readers of the program's spans (``host_wait_share.embed``,
``enqueue_ms.embed``, ``dispatch_ms.decode``, ``loop_step_ms.decode``) on
synthetic recordings of ``sonar_tpu_torch.utils.profiling``, on the CPU."""

import time

from perfbench.harness import bench
from perfbench.tests.conftest import ROOT
import pytest

TRACED = {"trace": object()}  # a traced run's observations: the readers read the recording


def reader(name):
    return bench.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py",
                             "perfbench_metric_" + name.replace(".", "_"))


def timed(name, ms, **attrs):
    from sonar_tpu_torch.utils.profiling import span

    with span(name, **attrs) as s:
        time.sleep(ms * 1e-3)
    return s


def test_the_embed_readers_read_a_synthetic_recording():
    from sonar_tpu_torch.utils.profiling import recording, span

    with recording() as rec:
        with span("pipeline.predict"):
            timed("pipeline.wait", 20, cause="pipeline.tokenize")
            timed("runtime.enqueue", 4, rows=8)
            timed("pipeline.wait", 10, cause=None)
            timed("runtime.enqueue", 6, rows=8)
    wall = rec.named("pipeline.predict")[0].end_ns - rec.named("pipeline.predict")[0].start_ns
    waits = sum(s.end_ns - s.start_ns for s in rec.named("pipeline.wait"))
    enq = [s.end_ns - s.start_ns for s in rec.named("runtime.enqueue")]
    share = reader("host_wait_share.embed").read(TRACED)
    assert share == pytest.approx(100.0 * waits / wall) and 30 < share < 100
    ms = reader("enqueue_ms.embed").read(TRACED)
    assert ms == pytest.approx(1e-6 * sum(enq) / 2) and 4 <= ms < 50


def test_the_decode_readers_read_a_synthetic_recording():
    from sonar_tpu_torch.utils.profiling import recording, span

    with recording() as rec:
        with span("pipeline.predict"):
            for steps, ms in ((50, 8), (40, 12)):
                d = timed("runtime.dispatch", ms, b_pad=32, prefix=2)
                t0 = time.time_ns()
                d.child("device.beam_loop", t0, t0 + steps * 5_300_000, steps=steps)
                timed("runtime.materialize", 1, rows=32)
    disp = [s.end_ns - s.start_ns for s in rec.named("runtime.dispatch")]
    assert reader("dispatch_ms.decode").read(TRACED) == pytest.approx(1e-6 * sum(disp) / 2)
    assert reader("loop_step_ms.decode").read(TRACED) == pytest.approx(5.3)
    loops = rec.named("device.beam_loop")
    assert [s.parent for s in loops] == [s.id for s in rec.named("runtime.dispatch")]


@pytest.mark.parametrize("name", ["host_wait_share.embed", "enqueue_ms.embed",
                                  "dispatch_ms.decode", "loop_step_ms.decode"])
def test_nothing_to_read_without_spans_or_tracing(name):
    from sonar_tpu_torch.utils.profiling import recording, span

    with recording():
        with span("unrelated"):
            pass
    read = reader(name).read
    assert read(TRACED) is None                  # no span of its own in the recording
    assert read({}) is None and read({"trace": None}) is None  # an untraced run


def test_a_traced_cpu_run_reports_the_span_readers():
    """On the CPU the embed cell reads both of its spans' metrics and the
    decode cell its dispatch (no card: no loop events)."""
    from perfbench.tests.conftest import run_cell

    embed = run_cell("text_embed.short", trace=1)["metrics"]
    assert {"host_wait_share.embed", "enqueue_ms.embed"} <= set(embed)
    assert 0 <= embed["host_wait_share.embed"]["value"] <= 100
    decode = run_cell("decode.beam5", trace=1)["metrics"]
    assert "dispatch_ms.decode" in decode and "loop_step_ms.decode" not in decode
