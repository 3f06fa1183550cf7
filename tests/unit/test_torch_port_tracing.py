"""The port's span recorder (``sonar_tpu_torch.utils.profiling``) and the
spans of the embed and decode paths, on the CPU.

- off, a span site keeps nothing and never builds ``record_function``;
- on, a span keeps its name, parent, thread, request and attributes, also
  on the threads a call hands work to (``prefetch``, ``map``'s pool);
- the consumer's wait is named after its producer's innermost span, and a
  full queue records the producer's backpressure;
- the stamps bracket the profiler's own event of the span, and a profiler
  session is a stretch of its own;
- a toy-width ``predict`` (static and dynamic batching) and a beam decode
  record their layers' spans under one request; ``trace`` writes the
  prefetch thread's spans into ``trace.json``.
"""

import contextvars
import dataclasses
import json
import os
from pathlib import Path
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from helpers import build_toy_spm_proto  # noqa: E402

from sonar_tpu_torch.data.pipeline import read_sequence  # noqa: E402
from sonar_tpu_torch.utils import profiling  # noqa: E402
from sonar_tpu_torch.utils.profiling import (  # noqa: E402
    annotate,
    last_recording,
    recording,
    span,
    trace,
)

TEXTS = ["hello world", "my name is paul", "i work as a teacher", "the cat sat on the mat " * 6,
         "bonjour", "je suis", "the cat", "hello " * 30, "a", "world is my name"] * 4


def _slow(fn, seconds=0.03):
    def call(x):
        with span("producer.step"):
            time.sleep(seconds)
            return fn(x)
    return call


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_keeps_nothing_and_builds_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = last_recording()
    n = len(before.spans) if before is not None else 0
    with span("off.outer", rows=3) as s:
        assert not s
        s.set(tokens=4)
        with annotate("off.inner"):
            pass
    out = list(read_sequence(range(6)).map(lambda x: x + 1, num_parallel_calls=2)
               .prefetch(2).and_return())
    assert out == [1, 2, 3, 4, 5, 6]
    assert last_recording() is before
    assert (len(before.spans) if before is not None else 0) == n


def test_on_records_name_parent_thread_and_attributes():
    with recording() as rec:
        with span("outer", rows=3) as outer:
            with span("inner") as inner:
                inner.set(tokens=7)
        assert rec.end_ns is None
    assert last_recording() is rec and rec.end_ns is not None
    (a, b) = rec.spans
    assert (a.name, b.name) == ("inner", "outer")
    assert a.parent == b.id == outer.id and b.parent is None
    assert a.request == b.request == b.id
    assert a.thread == b.thread == threading.get_native_id()
    assert a.attrs == {"tokens": 7} and b.attrs == {"rows": 3}
    assert b.start_ns <= a.start_ns <= a.end_ns <= b.end_ns
    assert rec.named("inner") == [a] and a.seconds >= 0


def test_annotate_is_a_span():
    with recording() as rec:
        with annotate("annotated"):
            pass
    assert [s.name for s in rec.spans] == ["annotated"]


def test_one_request_id_across_the_worker_threads():
    with recording() as rec:
        with span("root") as root:
            out = list(read_sequence(range(8)).map(_slow(lambda x: x * 2, 0.001),
                                                   num_parallel_calls=3)
                       .prefetch(2).and_return())
    assert out == [2 * x for x in range(8)]
    steps = rec.named("producer.step")
    assert len(steps) == 8
    assert all(s.request == root.id and s.parent == root.id for s in steps)
    assert all(s.thread != threading.get_native_id() for s in steps)
    assert all(s.request == root.id for s in rec.spans)


def test_spans_from_more_threads_than_cores_are_all_kept():
    """Threads that record at once, the interpreter switching between them
    often: no span is lost, every id is unique, each keeps its parent."""
    n_threads, per = (os.cpu_count() or 2) + 2, 100

    def work():
        for _ in range(per):
            with span("outer"):
                with span("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            with span("root") as root:
                threads = [threading.Thread(target=contextvars.copy_context().run, args=(work,))
                           for _ in range(n_threads)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    outer, inner = rec.named("outer"), rec.named("inner")
    assert len(outer) == len(inner) == n_threads * per
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    by_id = {s.id: s for s in outer}
    assert all(by_id[s.parent].thread == s.thread for s in inner)
    assert all(s.parent == root.id for s in outer)
    assert all(s.request == root.id for s in rec.spans)
    assert all(profiling.innermost(t) is None for t in threads)


def test_a_wait_names_its_cause_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = list(read_sequence(range(4)).map(_slow(lambda x: x)).prefetch(2).and_return())
    assert out == [0, 1, 2, 3]
    rec = last_recording()
    waits = rec.named("pipeline.wait")
    assert waits and all(w.thread == threading.get_native_id() for w in waits)
    assert {w.attrs["cause"] for w in waits} <= {None, "producer.step"}
    assert any(w.attrs["cause"] == "producer.step" for w in waits)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "pipeline.wait[producer.step]" in names
    assert "producer.step" not in names  # the profiler records its own thread alone


def test_a_full_queue_records_the_producers_backpressure():
    with recording() as rec:
        it = iter(read_sequence(range(6)).prefetch(1).and_return())
        got = [next(it)]
        time.sleep(0.3)  # the producer fills the queue and waits
        got += list(it)
    assert got == list(range(6))
    back = rec.named("pipeline.backpressure")
    assert back and all(s.thread != threading.get_native_id() for s in back)


def test_the_stamps_bracket_the_profilers_event():
    """Each span's stamps lie around the profiler's event of its name (on
    one clock: 1 ms of slack outside), and within 1 ms of it (the closest
    of five: a first call, or a pause of the interpreter, can lie between)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(8):
            with span(f"clock.{i}"):
                torch.ones(64).sum()
    mine = {s.name: s for s in last_recording().spans}
    ms, inner = 1_000_000, []
    for ev in prof.profiler.kineto_results.events():
        if ev.name() in mine and ev.name() >= "clock.3":
            s, start = mine[ev.name()], ev.start_ns()
            end = start + ev.duration_ns()
            assert s.start_ns - ms <= start <= end <= s.end_ns + ms
            inner.append(max(start - s.start_ns, s.end_ns - end))
    assert len(inner) == 5 and min(inner) < ms


def test_a_profiler_session_is_a_stretch_of_its_own():
    from torch.profiler import ProfilerActivity, profile

    recs = []
    with span("off.before"):  # the first site with recording off ends a stretch
        pass
    for name in ("session.one", "session.two"):
        with profile(activities=[ProfilerActivity.CPU]):
            with span(name):
                pass
        with span("off.between"):
            pass
        recs.append(last_recording())
    assert recs[0] is not recs[1]
    assert [s.name for s in recs[0].spans] == ["session.one"]
    assert [s.name for s in recs[1].spans] == ["session.two"]
    assert all(r.end_ns is not None for r in recs)


def test_trace_writes_the_prefetch_threads_spans(tmp_path: Path):
    with trace(str(tmp_path)):
        out = list(read_sequence(range(3)).map(_slow(lambda x: x)).prefetch(2).and_return())
    assert out == [0, 1, 2]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "producer.step" and e.get("cat") == "span"]
    assert len(steps) == 3
    assert all(e["tid"] != threading.get_native_id() and e["dur"] > 0 for e in steps)
    assert all("request" in e["args"] and "parent" in e["args"] for e in steps)


# -- the embed and decode paths --------------------------------------------------


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from sonar_tpu_torch.tokenizers.nllb import NllbTokenizer
    from sonar_tpu_torch.tokenizers.spm_proto import serialize_model_proto

    path = tmp_path_factory.mktemp("tracing") / "port_nllb.model"
    path.write_bytes(serialize_model_proto(build_toy_spm_proto()))
    return NllbTokenizer(path, langs=["eng_Latn", "fra_Latn"], default_lang="eng_Latn")


class _SlowTokenizer:
    """The toy tokenizer, its batched encode slowed so that the consumer
    waits on the prefetch thread."""

    def __init__(self, tok):
        self.tok = tok
        self.vocab_info = tok.vocab_info

    def create_encoder(self, **kwargs):
        enc = self.tok.create_encoder(**kwargs)

        class Encoder:
            def __call__(self, text):
                return enc(text)

            def encode_batch(self, texts):
                time.sleep(0.05)
                return enc.encode_batch(texts)

        return Encoder()


@pytest.mark.parametrize("batching", ["static", "dynamic"])
def test_predict_records_the_pipeline_and_runtime_spans(tokenizer, batching):
    from sonar_tpu_torch.assets.convert import init_text_encoder_params, text_encoder_from_numpy
    from sonar_tpu_torch.inference_pipelines.text import (
        TextToEmbeddingModelPipeline,
        TorchTextEncoder,
    )
    from sonar_tpu_torch.models.sonar_text import sonar_text_encoder_archs

    cfg = sonar_text_encoder_archs.get("toy")
    model = text_encoder_from_numpy(init_text_encoder_params(cfg), cfg)
    pipe = TextToEmbeddingModelPipeline(TorchTextEncoder(model, device="cpu"),
                                        _SlowTokenizer(tokenizer))
    kw = {"source_lang": "eng_Latn", "batching": batching, "batch_size": 8}
    plain = pipe.predict(TEXTS, **kw)
    with recording() as rec:
        emb = pipe.predict(TEXTS, **kw)
    np.testing.assert_array_equal(emb, plain)
    spans = _by_name(rec)
    assert {"pipeline.predict", "pipeline.tokenize", "pipeline.batch", "pipeline.wait",
            "runtime.enqueue", "runtime.upload", "runtime.copy_out",
            "pipeline.restore"} <= set(spans)
    (root,) = spans["pipeline.predict"]
    assert all(s.request == root.id for s in rec.spans)
    main = threading.get_native_id()
    (tok,) = spans["pipeline.tokenize"]
    assert tok.thread != main and tok.attrs["sentences"] == len(TEXTS)
    assert tok.attrs["tokens"] > len(TEXTS)
    batches = spans["pipeline.batch"]
    assert all(b.thread != main for b in batches)
    assert sum(b.attrs["used"] for b in batches) == len(TEXTS)
    assert all(b.attrs["used"] <= b.attrs["rows"] and b.attrs["tokens"] > 0 for b in batches)
    enq = spans["runtime.enqueue"]
    assert len(enq) == len(batches) and all(s.thread == main for s in enq)
    assert sum(s.attrs["rows"] for s in enq) == len(TEXTS)
    assert sum(s.attrs["tokens"] for s in enq) == sum(b.attrs["tokens"] for b in batches)
    ids = {s.id for s in enq}
    assert all(u.parent in ids for u in spans["runtime.upload"])
    assert spans["pipeline.wait"][0].thread == main
    (restore,) = spans["pipeline.restore"]
    assert restore.attrs["rows"] == len(TEXTS) and restore.parent == root.id


def test_the_beam_decode_records_dispatch_and_materialize(tokenizer):
    from sonar_tpu_torch.assets.convert import init_text_decoder_params, text_decoder_from_numpy
    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import TorchTextDecoder
    from sonar_tpu_torch.inference_pipelines.text import EmbeddingToTextModelPipeline
    from sonar_tpu_torch.models.sonar_text import sonar_text_decoder_archs

    base = sonar_text_decoder_archs.get("toy")
    cfg = dataclasses.replace(base, vocab_info=dataclasses.replace(
        base.vocab_info, size=tokenizer.vocab_info.size))
    decoder = TorchTextDecoder(text_decoder_from_numpy(init_text_decoder_params(cfg), cfg),
                               device="cpu")
    mem = np.random.default_rng(0).standard_normal((3, 1, cfg.model_dim)).astype(np.float32)
    config = BeamSearchConfig.from_kwargs(decoder.max_target_len, beam_size=2, max_gen_len=6)
    with recording() as rec:
        handle = decoder.generate_beam_async(mem, [3, 4], config)
        tokens, _, _ = decoder.materialize_beam(handle)
    assert tokens.shape[0] == 3
    spans = _by_name(rec)
    (dispatch,) = spans["runtime.dispatch"]
    (mat,) = spans["runtime.materialize"]
    assert dispatch.attrs == {"prefix": 2, "b_pad": 4} and mat.attrs == {"rows": 3}
    assert "device.beam_loop" not in spans  # CUDA events: on a card alone

    pipe = EmbeddingToTextModelPipeline(decoder, tokenizer)
    with recording() as rec:
        texts = pipe.predict(mem[:, 0], target_lang="fra_Latn", batch_size=2, beam_size=2,
                             max_gen_len=6)
    assert len(texts) == 3
    spans = _by_name(rec)
    (root,) = spans["pipeline.predict"]
    assert root.attrs == {"rows": 3}
    assert len(spans["runtime.dispatch"]) == len(spans["runtime.materialize"]) == 2
    assert [s.attrs["rows"] for s in spans["pipeline.detokenize"]] == [2, 1]
    assert all(s.request == root.id for s in rec.spans)
    assert profiling.DEVICE_THREAD not in {s.thread for s in rec.spans}
