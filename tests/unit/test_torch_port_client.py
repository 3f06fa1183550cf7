"""The port's ``SonarClient`` against the port's ``EmbeddingServer``.

The cases of ``test_client.py``: roundtrip, chunking, retry-on-shed (the
503/Retry-After contract), non-retryable 4xx, retries exhausted, keep-alive
reuse, on stub pipelines; and the three endpoints on toy pipelines of the
port against the JAX package's ``predict`` on the same weights (text atol
2e-4, speech atol 5e-4, translations equal).
"""

from pathlib import Path
import sys
import threading

import pytest

pytest.importorskip("torch")

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

from sonar_tpu_torch.client import ServerError, SonarClient, _retry_after_seconds  # noqa: E402
from sonar_tpu_torch.serving import EmbeddingServer  # noqa: E402


class EchoPipeline:
    """Deterministic text->vector stub: embedding = [len(t), ord(t[0])]."""

    def predict(self, texts, source_lang=None, batching=None):
        return np.asarray(
            [[float(len(t)), float(ord(t[0]))] for t in texts], np.float32
        )


@pytest.fixture()
def echo_server():
    srv = EmbeddingServer(EchoPipeline(), max_wait_ms=1).start()
    yield srv
    srv.stop()


def client_for(srv, **kw) -> SonarClient:
    host, port = srv.address
    return SonarClient(host, port, **{"timeout_s": 60, **kw})


def test_embed_roundtrip_and_order(echo_server):
    with client_for(echo_server) as c:
        texts = ["hello", "a", "worlds"]
        got = c.embed(texts, lang="eng_Latn")
        np.testing.assert_array_equal(got, EchoPipeline().predict(texts))
        assert c.healthz()["status"] == "ok"


def test_chunking_splits_requests_and_preserves_order(echo_server):
    with client_for(echo_server, chunk_size=2) as c:
        before = c.metrics()["embed"]["requests"]
        texts = ["alpha", "b", "charlie", "dd", "e"]
        got = c.embed(texts)
        after = c.metrics()["embed"]["requests"]
        assert after - before == 3  # ceil(5/2) sequential requests
        np.testing.assert_array_equal(got, EchoPipeline().predict(texts))
        assert c.embed([]).shape == (0, 0)


def test_4xx_is_not_retried(echo_server):
    with client_for(echo_server, max_retries=3, backoff_s=0.01) as c:
        before = c.metrics()["embed"]["requests"]
        with pytest.raises(ServerError) as e:
            c._request("POST", "/embed", {"texts": "not-a-list"})
        assert e.value.status == 400
        assert c.metrics()["embed"]["requests"] - before == 1  # single attempt


def test_retries_exhausted_reports_last_error():
    # nothing listens on this port; connection errors retry then give up
    c = SonarClient("127.0.0.1", 1, max_retries=1, backoff_s=0.01, timeout_s=10)
    with pytest.raises(ServerError, match="retries exhausted"):
        c.healthz()


def test_retry_after_parsing_is_defensive():
    from email.utils import formatdate
    import time as _time

    assert _retry_after_seconds({"Retry-After": "2"}) == 2.0
    assert _retry_after_seconds({"retry-after": "3"}) == 3.0  # any case
    assert _retry_after_seconds({}) == 0.0
    assert _retry_after_seconds({"Retry-After": "garbage"}) == 0.0
    # RFC 7231 HTTP-date form (proxies rewrite to this)
    future = formatdate(_time.time() + 5, usegmt=True)
    got = _retry_after_seconds({"Retry-After": future})
    assert 0.0 < got <= 6.0
    past = formatdate(_time.time() - 60, usegmt=True)
    assert _retry_after_seconds({"Retry-After": past}) == 0.0


def test_connection_is_reused_across_requests(echo_server):
    # the server speaks HTTP/1.1 keep-alive; the client's single
    # HTTPConnection must survive consecutive requests (same socket)
    with client_for(echo_server) as c:
        c.embed(["one"])
        sock = c._conn.sock
        assert sock is not None
        c.embed(["two"])
        c.metrics()
        assert c._conn.sock is sock


def test_503_shed_is_retried_until_capacity_returns():
    entered = threading.Event()
    release = threading.Event()

    class Blocking:
        def predict(self, texts, source_lang=None, batching=None):
            entered.set()
            assert release.wait(timeout=30)
            return np.zeros((len(texts), 2), np.float32)

    srv = EmbeddingServer(
        Blocking(), max_wait_ms=1, max_pending_sentences=1
    ).start()
    try:
        results = {}

        def bg(name):
            with client_for(srv, max_retries=0) as c0:
                results[name] = c0.embed(["x"])

        ta = threading.Thread(target=bg, args=("a",))
        ta.start()
        assert entered.wait(10)  # worker blocked; backlog empty
        tb = threading.Thread(target=bg, args=("b",))
        tb.start()
        for _ in range(1000):  # B queued -> backlog at the bound
            if srv.batcher.pending >= 1:
                break
            threading.Event().wait(0.01)
        assert srv.batcher.pending >= 1

        # a releaser thread frees the server while the client is backing off
        def release_after_first_shed():
            for _ in range(1000):
                if srv.metrics["embed"].shed >= 1:
                    break
                threading.Event().wait(0.01)
            release.set()

        tr = threading.Thread(target=release_after_first_shed)
        tr.start()
        with client_for(srv, max_retries=8, backoff_s=0.05) as c:
            got = c.embed(["y"])  # first attempt sheds (503), retry succeeds
        assert got.shape == (1, 2)
        assert srv.metrics["embed"].shed >= 1
        for t in (ta, tb, tr):
            t.join(30)
            assert not t.is_alive()
        assert results["a"].shape == (1, 2) and results["b"].shape == (1, 2)
    finally:
        release.set()
        srv.stop()


def test_three_endpoints_match_jax(tmp_path):
    toys = build_toys(tmp_path)
    pipes, ref = port_pipelines(toys), jax_pipelines(toys)
    srv = EmbeddingServer(pipes["embed"], max_wait_ms=5, translator=pipes["translate"],
                          speech_pipeline=pipes["embed_speech"]).start()
    texts = ["hello world", "my name is paul", "the cat sat"]
    clips = waves(seed=1)
    try:
        with client_for(srv, chunk_size=2) as c:
            emb = c.embed(texts, lang="eng_Latn")
            out = c.translate(texts, source_lang="eng_Latn", target_lang="fra_Latn")
            semb = c.embed_speech(clips)
            assert c.metrics()["embed"]["requests"] == 2  # two chunks
    finally:
        srv.stop()
    np.testing.assert_allclose(emb, np.asarray(ref["embed"].predict(
        texts, source_lang="eng_Latn", batching="static"), np.float32), atol=TEXT_ATOL)
    # The client's chunks of 2 are two requests; JAX translates them as two
    # calls too.
    want = [t for i in (0, 2) for t in ref["translate"].predict(
        texts[i:i + 2], source_lang="eng_Latn", target_lang="fra_Latn")]
    assert out == want
    np.testing.assert_allclose(semb, np.asarray(ref["embed_speech"].predict(clips), np.float32),
                               atol=SPEECH_ATOL)
