"""The port's ``EmbeddingServer`` (``sonar_tpu_torch.serving``) on the CPU.

The cases of ``test_serving.py`` against the port's server: /embed,
/translate and /embed_speech on toy pipelines of the port, each reply held
against the JAX package's ``predict`` on the same weights (text atol 2e-4,
speech atol 5e-4, translations equal) and against the port's own direct
``predict`` (equal); micro-batching and /metrics; error paths; load
shedding with 503 and Retry-After; drain and stop; the warmup flag; a
failing ``predict`` answered with a 500. ``MicroBatcher`` sheds at the same
submits as the JAX package's on one scripted sequence (the backlog counts
queued items only). Every server is stopped by its fixture or a
``finally``; every HTTP call has a timeout; waits are on events.
"""

import json
from pathlib import Path
import queue
import sys
import threading
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).parent.parent))
from torch_port_toys import (  # noqa: E402
    SPEECH_ATOL,
    TEXT_ATOL,
    build_toys,
    jax_pipelines,
    port_pipelines,
    waves,
)

from sonar_tpu import serving as jax_serving  # noqa: E402
from sonar_tpu_torch.serving import (  # noqa: E402
    EmbeddingServer,
    MicroBatcher,
    ServerOverloadedError,
)

HTTP_TIMEOUT_S = 60
TEXTS = ["hello world", "my name is paul"]


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    toys = build_toys(tmp_path_factory.mktemp("toys"))
    return toys, jax_pipelines(toys)


@pytest.fixture(scope="module")
def server(toys):
    pipe = port_pipelines(toys[0])["embed"]
    srv = EmbeddingServer(pipe, max_wait_ms=10).start()
    yield srv, pipe
    srv.stop()


@pytest.fixture(scope="module")
def full_server(toys):
    pipes = port_pipelines(toys[0])
    srv = EmbeddingServer(pipes["embed"], max_wait_ms=10, translator=pipes["translate"],
                          speech_pipeline=pipes["embed_speech"]).start()
    yield srv, pipes
    srv.stop()


def _url(addr, path):
    return f"http://{addr[0]}:{addr[1]}{path}"


def _post(addr, payload, path="/embed"):
    req = urllib.request.Request(_url(addr, path), data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def _get(addr, path):
    with urllib.request.urlopen(_url(addr, path), timeout=HTTP_TIMEOUT_S) as r:
        return json.loads(r.read())


def _wait_until(cond, timeout_s=10.0):
    done = threading.Event()
    for _ in range(int(timeout_s / 0.01)):
        if cond():
            return True
        done.wait(0.01)
    return cond()


def _join_all(threads):
    for t in threads:
        t.join(HTTP_TIMEOUT_S)
    assert not any(t.is_alive() for t in threads)


# -- the three endpoints against JAX ---------------------------------------------------


def test_embed_roundtrip_matches_jax_and_direct_predict(server, toys):
    srv, pipe = server
    out = _post(srv.address, {"texts": TEXTS, "lang": "eng_Latn"})
    got = np.asarray(out["embeddings"], np.float32)
    direct = pipe.predict(TEXTS, source_lang="eng_Latn", batching="static")
    want = np.asarray(toys[1]["embed"].predict(TEXTS, source_lang="eng_Latn",
                                               batching="static"), np.float32)
    assert out["dim"] == want.shape[1] == 32
    np.testing.assert_array_equal(got, direct)  # the same batch: the same bits
    np.testing.assert_allclose(got, want, atol=TEXT_ATOL)


def test_translate_endpoint_matches_jax(full_server, toys):
    srv, pipes = full_server
    texts = TEXTS + ["the cat sat on the mat", "bonjour"]
    out = _post(srv.address, {"texts": texts, "source_lang": "eng_Latn",
                              "target_lang": "fra_Latn"}, path="/translate")
    want = toys[1]["translate"].predict(texts, source_lang="eng_Latn", target_lang="fra_Latn")
    assert out["translations"] == list(want)
    assert out["translations"] == pipes["translate"].predict(
        texts, source_lang="eng_Latn", target_lang="fra_Latn")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.address, {"texts": texts}, path="/translate")  # missing langs
    assert e.value.code == 400


def test_embed_speech_endpoint_matches_jax(full_server, toys):
    srv, pipes = full_server
    clips = waves()
    out = _post(srv.address, {"audios": [w.tolist() for w in clips]}, path="/embed_speech")
    got = np.asarray(out["embeddings"], np.float32)
    want = np.asarray(toys[1]["embed_speech"].predict(clips), np.float32)
    assert out["dim"] == want.shape[1]
    np.testing.assert_array_equal(got, pipes["embed_speech"].predict(clips))
    np.testing.assert_allclose(got, want, atol=SPEECH_ATOL)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.address, {"audios": "nope"}, path="/embed_speech")
    assert e.value.code == 400


def test_all_endpoints_at_once(full_server, toys):
    """Concurrent clients on the three endpoints: each endpoint's worker
    runs its own pipeline; every reply matches JAX's."""
    srv, _ = full_server
    texts = [[f"hello {w}"] for w in ("world", "cat", "paul")]
    clips = waves(seed=3)
    results = {}

    def embed(i):
        results[("embed", i)] = _post(srv.address, {"texts": texts[i], "lang": "eng_Latn"})

    def speech():
        results["speech"] = _post(srv.address, {"audios": [w.tolist() for w in clips]},
                                  path="/embed_speech")

    def translate():
        results["translate"] = _post(srv.address, {"texts": TEXTS, "source_lang": "eng_Latn",
                                                   "target_lang": "eng_Latn"},
                                     path="/translate")

    threads = [threading.Thread(target=embed, args=(i,)) for i in range(3)]
    threads += [threading.Thread(target=speech), threading.Thread(target=translate)]
    for t in threads:
        t.start()
    _join_all(threads)
    jp = toys[1]
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(results[("embed", i)]["embeddings"], np.float32),
            np.asarray(jp["embed"].predict(texts[i], source_lang="eng_Latn",
                                           batching="static"), np.float32), atol=TEXT_ATOL)
    np.testing.assert_allclose(np.asarray(results["speech"]["embeddings"], np.float32),
                               np.asarray(jp["embed_speech"].predict(clips), np.float32),
                               atol=SPEECH_ATOL)
    assert results["translate"]["translations"] == list(jp["translate"].predict(
        TEXTS, source_lang="eng_Latn", target_lang="eng_Latn"))


# -- micro-batching and metrics -----------------------------------------------------------


def test_concurrent_requests_are_batched_and_correct(server, toys):
    srv, _ = server
    before = _get(srv.address, "/metrics")["embed"]
    texts_per_client = [[f"hello {w}"] for w in ("world", "cat", "paul", "name")]
    results = [None] * len(texts_per_client)

    def client(i):
        results[i] = _post(srv.address, {"texts": texts_per_client[i], "lang": "eng_Latn"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    _join_all(threads)
    for i, res in enumerate(results):
        want = toys[1]["embed"].predict(texts_per_client[i], source_lang="eng_Latn",
                                        batching="static")
        np.testing.assert_allclose(np.asarray(res["embeddings"], np.float32),
                                   np.asarray(want, np.float32), atol=TEXT_ATOL)
    after = _get(srv.address, "/metrics")["embed"]
    assert after["requests"] - before["requests"] == 4
    assert after["items"] - before["items"] == 4
    assert after["errors"] == before["errors"]
    assert after["batch_items"] - before["batch_items"] == 4
    assert 1 <= after["batches"] - before["batches"] <= 4
    assert after["latency_p50_ms"] > 0
    assert after["latency_p95_ms"] >= after["latency_p50_ms"]
    assert after["batch_occupancy_mean"] >= 1
    enc = after["encoder"]
    assert enc["padded_tokens"] >= enc["true_tokens"] > 0
    assert 0.0 <= enc["padding_waste"] < 1.0


def test_metrics_counts_errors_and_timeouts_separately(server):
    srv, _ = server
    before = _get(srv.address, "/metrics")["embed"]
    with pytest.raises(urllib.error.HTTPError):
        _post(srv.address, {"texts": ["x"], "lang": "xx_Fake"})
    after = _get(srv.address, "/metrics")["embed"]
    assert after["errors"] - before["errors"] == 1
    assert after["timeouts"] == before["timeouts"]  # 400s are not 504s


def test_error_paths(server):
    srv, _ = server
    assert _post(srv.address, {"texts": []})["embeddings"] == []
    for payload, path, code in (({"texts": "not-a-list"}, "/embed", 400),
                                ({"texts": ["x"], "lang": "xx_Fake"}, "/embed", 400),
                                ({"texts": ["x"]}, "/nope", 404),
                                ({"texts": ["x"], "lang": ["eng_Latn"]}, "/embed", 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.address, payload, path=path)
        assert e.value.code == code
    assert _get(srv.address, "/healthz")["status"] == "ok"
    out = _post(srv.address, {"texts": ["still works"], "lang": "eng_Latn"})
    assert len(out["embeddings"]) == 1


def test_unconfigured_endpoints_404(server):
    srv, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.address, {"texts": ["x"], "source_lang": "eng_Latn",
                            "target_lang": "fra_Latn"}, path="/translate")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.address, {"audios": [[0.1, 0.2]]}, path="/embed_speech")
    assert e.value.code == 404


def test_non_object_json_body_is_rejected(server):
    srv, _ = server
    for body in ([1, 2, 3], "just a string"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.address, body)
        assert e.value.code == 400
    out = _post(srv.address, {"texts": ["hello"], "lang": "eng_Latn"})
    assert len(out["embeddings"]) == 1


def test_failed_predict_is_a_500_with_no_retry():
    """A predict that raises fails its request with a 500; the server
    retries it on no other path, and the worker lives on."""
    calls = []

    class Failing:
        def predict(self, texts, source_lang=None, batching=None):
            calls.append(list(texts))
            if texts[0] == "boom":
                raise RuntimeError("kernel failed")
            return np.ones((len(texts), 2), np.float32)

    srv = EmbeddingServer(Failing(), max_wait_ms=1).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.address, {"texts": ["boom"], "lang": "eng_Latn"})
        assert e.value.code == 500
        assert "kernel failed" in json.loads(e.value.read())["error"]
        assert calls == [["boom"]]
        assert _post(srv.address, {"texts": ["ok"], "lang": "eng_Latn"})["dim"] == 2
        assert _get(srv.address, "/metrics")["embed"]["errors"] == 1
    finally:
        srv.stop()


def test_worker_and_http_threads_are_daemons():
    class Echo:
        def predict(self, texts, source_lang=None, batching=None):
            return np.zeros((len(texts), 2), np.float32)

    srv = EmbeddingServer(Echo(), max_wait_ms=1).start()
    try:
        assert srv.batcher._thread.daemon and srv._serve_thread.daemon
    finally:
        srv.stop()
    assert not srv.batcher._thread.is_alive() and not srv._serve_thread.is_alive()


# -- load shedding, drain, stop ---------------------------------------------------------------


def test_microbatcher_load_shedding_bound_and_recovery():
    entered, release = threading.Event(), threading.Event()

    def blocking_predict(items, _key):
        entered.set()
        assert release.wait(timeout=30)
        return [x * 2 for x in items]

    mb = MicroBatcher(blocking_predict, max_items=8, max_wait_ms=1, max_pending_items=2)
    try:
        fut_a = mb.submit([1], key="k")
        assert entered.wait(timeout=10)  # worker now blocked in predict(A)
        fut_b = mb.submit([2, 3], key="k")  # backlog 0 -> 2: admitted
        with pytest.raises(ServerOverloadedError, match="max_pending_items"):
            mb.submit([4], key="k")  # backlog 2 >= 2: shed
        release.set()
        assert fut_a.result(timeout=30) == [2]
        assert fut_b.result(timeout=30) == [4, 6]
        assert mb.submit([5], key="k").result(timeout=30) == [10]
        assert mb._pending_items == 0
    finally:
        release.set()
        mb.close()


def _scripted_sheds(batcher_cls, overloaded):
    """Admitted (True) or shed (False) for each submit of one scripted
    sequence, with the worker held inside predict at set points, and the
    batches predict saw."""
    entered, release = queue.Queue(), threading.Semaphore(0)

    def predict(items, _key):
        entered.put(list(items))
        assert release.acquire(timeout=30)
        return list(items)

    mb = batcher_cls(predict, max_items=16, max_wait_ms=1, max_pending_items=3)
    outcomes, futures = [], []

    def submit(items):
        try:
            futures.append(mb.submit(items, key="k"))
            outcomes.append(True)
        except overloaded:
            outcomes.append(False)

    seen = []
    try:
        submit([1])
        seen.append(entered.get(timeout=10))  # A in predict: 1 in flight, 0 queued
        submit([2, 2])                        # 2 queued
        submit([3])                           # 3 queued
        submit([4])                           # 3 >= 3: shed
        submit([5] * 5)                       # shed
        release.release()                     # A done; B and C go in together
        seen.append(entered.get(timeout=10))  # 3 in flight, 0 queued
        submit([6] * 4)                       # in-flight items do not count: admitted
        submit([7])                           # 4 queued >= 3: shed
        release.release()
        seen.append(entered.get(timeout=10))
        release.release()
        results = [f.result(timeout=30) for f in futures]
    finally:
        for _ in range(4):
            release.release()
        mb.close()
    return outcomes, seen, results


def test_microbatcher_sheds_at_the_same_submits_as_jax():
    port = _scripted_sheds(MicroBatcher, ServerOverloadedError)
    ref = _scripted_sheds(jax_serving.MicroBatcher, jax_serving.ServerOverloadedError)
    assert port == ref
    assert port[0] == [True, True, True, False, False, True, False]
    assert port[1] == [[1], [2, 2, 3], [6] * 4]


def test_http_load_shedding_503_retry_after_and_metrics():
    entered, release = threading.Event(), threading.Event()

    class StubPipeline:
        def predict(self, texts, source_lang=None, batching=None):
            entered.set()
            assert release.wait(timeout=30)
            return np.zeros((len(texts), 4), np.float32)

    srv = EmbeddingServer(StubPipeline(), max_wait_ms=1, max_pending_sentences=2).start()
    try:
        results = {}

        def client(name, n):
            try:
                results[name] = _post(srv.address, {"texts": ["x"] * n, "lang": "eng_Latn"})
            except urllib.error.HTTPError as e:
                results[name] = e

        ta = threading.Thread(target=client, args=("a", 1))
        ta.start()
        assert entered.wait(timeout=10)  # worker blocked inside predict(A)
        tb = threading.Thread(target=client, args=("b", 2))
        tb.start()
        assert _wait_until(lambda: srv.batcher.pending >= 1)  # B queued
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(srv.address, {"texts": ["x"], "lang": "eng_Latn"})
        assert exc.value.code == 503
        assert exc.value.headers.get("Retry-After") == "1"
        assert _get(srv.address, "/metrics")["embed"]["shed"] == 1
        release.set()
        _join_all([ta, tb])
        assert results["a"]["dim"] == 4 and results["b"]["dim"] == 4
    finally:
        release.set()
        srv.stop()


def test_graceful_drain_refuses_new_work_but_finishes_accepted():
    entered, release = threading.Event(), threading.Event()

    class Blocking:
        def predict(self, texts, source_lang=None, batching=None):
            entered.set()
            assert release.wait(timeout=30)
            return np.zeros((len(texts), 3), np.float32)

    srv = EmbeddingServer(Blocking(), max_wait_ms=1).start()
    try:
        results = {}

        def client():
            results["a"] = _post(srv.address, {"texts": ["x"], "lang": "eng_Latn"})

        t = threading.Thread(target=client)
        t.start()
        assert entered.wait(10)
        assert srv.pending == 1
        assert _get(srv.address, "/healthz")["pending"] == 1
        srv.drain()
        assert _get(srv.address, "/healthz")["status"] == "draining"
        before = _get(srv.address, "/metrics")["embed"]
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.address, {"texts": ["y" * 2_000_000], "lang": "eng_Latn"})
        assert e.value.code == 503
        assert e.value.headers.get("Retry-After") == "1"
        after = _get(srv.address, "/metrics")["embed"]
        assert after["shed"] - before["shed"] == 1
        assert after["errors"] - before["errors"] == 1
        release.set()
        _join_all([t])
        assert results["a"]["dim"] == 3
        assert _wait_until(lambda: srv.pending == 0)
    finally:
        release.set()
        srv.stop()


def test_stop_with_drain_timeout_completes_backlog():
    gate = threading.Event()

    class Gated:
        def predict(self, texts, source_lang=None, batching=None):
            assert gate.wait(timeout=30)
            return np.ones((len(texts), 2), np.float32)

    srv = EmbeddingServer(Gated(), max_wait_ms=1).start()
    results = {}

    def client(i):
        results[i] = _post(srv.address, {"texts": [f"t{i}"], "lang": "eng_Latn"})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        assert _wait_until(lambda: srv.pending == 3)  # one in predict, two queued
        threading.Timer(0.2, gate.set).start()  # the backlog clears during stop's wait
        srv.stop(drain_timeout_s=30.0)
    finally:
        gate.set()
        if srv._serve_thread.is_alive():
            srv.stop()
    _join_all(threads)
    assert all(results[i]["dim"] == 2 for i in range(3)), results


def test_microbatcher_unhashable_key_isolated_and_close_race():
    mb = MicroBatcher(lambda items, key: [x * 2 for x in items], max_items=16,
                      max_wait_ms=30.0)
    bad = mb.submit([1], key=["unhashable"])
    good = mb.submit([2], key="k")
    assert good.result(timeout=10) == [4]
    with pytest.raises(TypeError):
        bad.result(timeout=10)
    mb.close()
    late = mb.submit([3], key="k")
    with pytest.raises(RuntimeError, match="shutting down"):
        late.result(timeout=5)


# -- warmup and precision ---------------------------------------------------------------------


def test_server_warmup_flag(toys, monkeypatch):
    """warmup=True runs every endpoint's warmup, in order, before the
    socket opens (two static buckets for /embed here: the subject is the
    wiring); replies are unchanged."""
    import sonar_tpu_torch.inference_pipelines.text as text_mod

    monkeypatch.setattr(text_mod, "_static_len_buckets_for", lambda max_len: (8, 16))
    pipes = port_pipelines(toys[0])
    calls = []
    for name, obj in (("embed", pipes["embed"].model), ("translate", pipes["translate"]),
                      ("embed_speech", pipes["embed_speech"])):
        monkeypatch.setattr(obj, "warmup", lambda *a, _f=obj.warmup, _n=name, **k:
                            (calls.append((_n, _f(*a, **k))), calls[-1][1])[1])
    srv = EmbeddingServer(pipes["embed"], max_wait_ms=5, warmup=True,
                          translator=pipes["translate"],
                          speech_pipeline=pipes["embed_speech"]).start()
    try:
        assert [n for n, _ in calls] == ["embed", "translate", "embed_speech"]
        assert calls[0][1] == 2 and all(n > 0 for _, n in calls)
        out = _post(srv.address, {"texts": ["hello world"], "lang": "eng_Latn"})
        want = toys[1]["embed"].predict(["hello world"], source_lang="eng_Latn",
                                        batching="static")
        np.testing.assert_allclose(np.asarray(out["embeddings"], np.float32),
                                   np.asarray(want, np.float32), atol=TEXT_ATOL)
    finally:
        srv.stop()


def test_fp32_endpoints_at_once_keep_the_callers_flags(toys):
    """Two fp32 models served at once (text and speech, concurrent
    clients) with TF32 switched on by the caller: the replies match JAX's
    and the caller's three flags read the same afterwards."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    set_flags = (True, True, torch.get_float32_matmul_precision())
    pipes = port_pipelines(toys[0])
    srv = EmbeddingServer(pipes["embed"], max_wait_ms=1,
                          speech_pipeline=pipes["embed_speech"]).start()
    clips = waves(seed=7, lengths=(4000, 7000, 5000))
    results = {}
    try:
        def text(i):
            results[("t", i)] = _post(srv.address, {"texts": [TEXTS[i % 2]], "lang": "eng_Latn"})

        def speech(i):
            results[("s", i)] = _post(srv.address, {"audios": [clips[i % 3].tolist()]},
                                      path="/embed_speech")

        threads = [threading.Thread(target=f, args=(i,)) for i in range(4) for f in (text, speech)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        srv.stop()
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                 torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])
    assert after == set_flags
    jp = toys[1]
    for i in range(4):
        np.testing.assert_allclose(
            np.asarray(results[("t", i)]["embeddings"], np.float32),
            np.asarray(jp["embed"].predict([TEXTS[i % 2]], source_lang="eng_Latn",
                                           batching="static"), np.float32), atol=TEXT_ATOL)
        np.testing.assert_allclose(
            np.asarray(results[("s", i)]["embeddings"], np.float32),
            np.asarray(jp["embed_speech"].predict([clips[i % 3]]), np.float32),
            atol=SPEECH_ATOL)


def test_pipeline_warmups(full_server):
    _, pipes = full_server
    assert pipes["translate"].warmup(batch_size=2, max_gen_len=3) >= 2
    assert pipes["embed_speech"].warmup(batch_size=2, max_wave_len=16000) == 1
