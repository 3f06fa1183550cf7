"""The speech path's spans and counter (``inference_pipelines/speech.py``) on
the CPU at toy width: ``predict`` records its request's layers under
``recording()`` and nothing while recording is off, and
``TorchSpeechEncoder.stats`` counts the clips and Conformer positions a
hand count gives."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sonar_tpu_torch.assets.convert import (  # noqa: E402
    init_speech_encoder_params,
    speech_encoder_from_numpy,
)
from sonar_tpu_torch.inference_pipelines import speech  # noqa: E402
from sonar_tpu_torch.models.sonar_speech import sonar_speech_encoder_archs  # noqa: E402
from sonar_tpu_torch.utils.profiling import last_recording, recording  # noqa: E402

# Five clips, predict(batch_size=3): sorted, the three shortest (1.2-1.9 s) pad
# to the 2-s bucket in 4 rows, the other two (2.6 and 4.5 s) to the 5-s one in 2.
SAMPLES = [41600, 19200, 30400, 72000, 24000]
BATCHES = [(3, 4, 32000), (2, 2, 80000)]  # (clips, rows run, samples a row)


def _frames(n):
    return 1 + (n - 400) // 160 if n >= 400 else 0


@pytest.fixture(scope="module")
def pipe():
    cfg = sonar_speech_encoder_archs.get("toy")
    model = speech_encoder_from_numpy(init_speech_encoder_params(cfg, seed=1), cfg)
    return speech.SpeechToEmbeddingModelPipeline(speech.TorchSpeechEncoder(model, device="cpu"))


@pytest.fixture(scope="module")
def waves():
    rng = np.random.default_rng(0)
    return [(0.1 * rng.standard_normal(n)).astype(np.float32) for n in SAMPLES]


def test_predict_records_the_speech_spans(pipe, waves):
    with recording() as rec:
        out = pipe.predict(waves, batch_size=3)
    assert out.shape == (5, 32)
    (root,) = rec.named("pipeline.predict")
    assert root.attrs == {"clips": 5} and root.parent is None
    names = ("pipeline.batch", "runtime.upload", "runtime.fbank", "runtime.enqueue",
             "runtime.copy_out")
    spans = {n: rec.named(n) for n in names}
    assert all(len(spans[n]) == 2 for n in names)
    for s in (x for n in names for x in spans[n]):
        assert s.parent == root.id and s.request == root.id
    assert [(s.attrs["rows"], s.attrs["padded_rows"], s.attrs["samples"])
            for s in spans["pipeline.batch"]] == BATCHES
    assert [(s.attrs["rows"], s.attrs["length"]) for s in spans["runtime.enqueue"]] == [
        (rows, _frames(t) // 2) for _, rows, t in BATCHES]
    assert [s.attrs["rows"] for s in spans["runtime.copy_out"]] == [3, 2]
    for i in range(2):  # in order within a batch
        order = [spans[n][i].start_ns for n in names]
        assert order == sorted(order)


def test_nothing_is_recorded_with_recording_off(pipe, waves):
    before = last_recording()
    n = len(before.spans) if before is not None else 0
    pipe.predict(waves, batch_size=3)
    assert last_recording() is before
    assert (len(before.spans) if before is not None else 0) == n


def test_stats_count_clips_and_positions_by_hand(pipe, waves):
    enc = pipe.model
    start = enc.stats.snapshot()
    pipe.predict(waves, batch_size=3)
    pipe.predict(waves[:1], batch_size=3)
    got = {k: v - start[k] for k, v in enc.stats.snapshot().items() if k != "padding_waste"}
    seq = [_frames(n) // 2 for n in SAMPLES]
    padded = sum(rows * (_frames(t) // 2) for _, rows, t in BATCHES) + 1 * (_frames(48000) // 2)
    assert got == {"clips": 6, "batches": 3, "true_seq": sum(seq) + seq[0],
                   "true_seq_sq": sum(s * s for s in seq) + seq[0] ** 2, "padded_seq": padded}
