"""Model server with request micro-batching, over the port's pipelines.

The port's copy of ``sonar_tpu.serving``: concurrent HTTP requests are
coalesced by background batchers into one pipeline ``predict`` call per
(endpoint, key) group, so a request shares the device's batched work with
the requests that arrived beside it instead of paying a call per sentence.
It serves ``sonar_tpu_torch``'s pipelines, of which it uses ``predict``,
``warmup`` and the text encoder's padding counters (``model.stats``):
``TextToEmbeddingModelPipeline`` behind /embed (static batching),
``TextToTextModelPipeline`` behind /translate and
``SpeechToEmbeddingModelPipeline`` behind /embed_speech. Each endpoint has
one worker thread and should have a pipeline object of its own; the
pipelines run on the GPU unless they were built with ``device="cpu"``.
A failed ``predict`` fails its requests with a 5xx; nothing is retried on
another path.

Stdlib-only (``http.server`` + ``ThreadingHTTPServer``).

API:
    POST /embed         {"texts": ["...", ...], "lang": "eng_Latn"}
        -> {"embeddings": [[...], ...], "dim": D}
    POST /translate     {"texts": [...], "source_lang": "...", "target_lang": "..."}
        -> {"translations": ["...", ...]}          (if a translator is configured)
    POST /embed_speech  {"audios": [[...16 kHz floats...], ...]}
        -> {"embeddings": [[...], ...], "dim": D}  (if a speech encoder is configured)
    GET  /healthz -> {"status": "ok", "pending": N}
    GET  /metrics -> per-endpoint request/batch counters, latency
                     percentiles, batch occupancy, encoder padding waste

Overload behavior: each endpoint's backlog is bounded
(``max_pending_sentences``, default 4096 items); a request arriving at a
full backlog is shed with HTTP 503 + ``Retry-After`` instead of queueing
into a guaranteed timeout (the ``shed`` counter on /metrics tracks this).
The backlog counts queued items only: items a worker has taken into
``predict`` do not count, as in the JAX package. Server-side timeouts
reply 504.

Lifecycle: ``warmup=True`` runs every serving shape once (which builds
the CUDA kernels) before the socket opens; ``drain()`` begins a graceful shutdown — new POSTs get 503
(+``Retry-After``), already-accepted work completes, ``/healthz`` flips
to ``{"status": "draining"}`` so load balancers pull the instance — and
``stop(drain_timeout_s=...)`` drains, waits for the backlog to clear,
then closes.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import json
import logging
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class EndpointMetrics:
    """Thread-safe per-endpoint serving metrics.

    Counters are monotonic for the server's lifetime; latency and
    batch-occupancy gauges are computed over bounded reservoirs of the most
    recent observations (O(1) memory, recency-weighted like production
    sliding-window percentiles)."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.requests = 0
        self.items = 0          # sentences / waveforms / texts across requests
        self.batches = 0        # predict calls issued by the micro-batcher
        self.batch_items = 0    # items across those predict calls
        self.errors = 0         # 4xx/5xx replies
        self.timeouts = 0       # server-side 504s (subset of errors)
        self.shed = 0           # 503s from backlog load shedding (subset)
        self._lat: deque = deque(maxlen=window)      # seconds, ok requests
        self._occ: deque = deque(maxlen=window)      # items per predict call

    def observe_request(self, n_items: int, latency_s: float,
                        ok: bool, timeout: bool = False,
                        shed: bool = False) -> None:
        with self._lock:
            self.requests += 1
            self.items += n_items
            if ok:
                self._lat.append(latency_s)
            else:
                self.errors += 1
                if timeout:
                    self.timeouts += 1
                if shed:
                    self.shed += 1

    def observe_batch(self, n_items: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_items += n_items
            self._occ.append(n_items)

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            occ = list(self._occ)
            out = {
                "requests": self.requests,
                "items": self.items,
                "batches": self.batches,
                "batch_items": self.batch_items,
                "errors": self.errors,
                "timeouts": self.timeouts,
                "shed": self.shed,
            }
        out["latency_p50_ms"] = round(_percentile(lat, 0.50) * 1e3, 2)
        out["latency_p95_ms"] = round(_percentile(lat, 0.95) * 1e3, 2)
        out["batch_occupancy_mean"] = (
            round(sum(occ) / len(occ), 2) if occ else 0.0
        )
        return out


class ServerOverloadedError(RuntimeError):
    """Backlog exceeds the shed threshold — reject instead of queueing.

    Raised by ``MicroBatcher.submit`` when ``max_pending_items`` is set and
    the queue already holds that many items. Unbounded queueing turns an
    overload into memory growth plus guaranteed client timeouts; shedding
    at admission keeps latency bounded for the requests already accepted
    and tells well-behaved clients to back off (HTTP 503 + Retry-After).
    """


class MicroBatcher:
    """Coalesce concurrent requests into batched predict calls.

    Requests enqueue (items, key, future); a single worker drains up to
    ``max_items`` items, waiting at most ``max_wait_ms`` after the first
    arrival so a lone request is never stalled for long. Each drain groups
    by key (one ``predict_fn(flat_items, key)`` per key) and resolves
    futures with each request's slice of the results.

    ``max_pending_items`` bounds the backlog: a submit that arrives while
    the queue already holds that many items raises
    ``ServerOverloadedError``. The bound applies to the backlog *before*
    the new request, so a single large request is always admitted when the
    queue is drained (bulk clients need not chunk to the bound). Items the
    worker has already taken into ``predict`` are not part of the backlog:
    this is the JAX package's admission rule, kept so that both servers
    shed at the same submits.
    """

    def __init__(
        self,
        predict_fn: Callable[[List, object], Sequence],
        max_items: int = 256,
        max_wait_ms: float = 5.0,
        metrics: Optional[EndpointMetrics] = None,
        max_pending_items: Optional[int] = None,
    ):
        self.predict_fn = predict_fn
        self.metrics = metrics
        self.max_items = max_items
        self.max_wait = max_wait_ms / 1000.0
        self.max_pending_items = max_pending_items
        self._q: "queue.Queue" = queue.Queue()
        self._pending_items = 0   # queued, not yet picked up by the worker
        self._inflight_items = 0  # popped by the worker, predict not done
        self._pending_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, items: Sequence, key: Any = None) -> Future:
        fut: Future = Future()
        items = list(items)
        with self._pending_lock:
            if (
                self.max_pending_items is not None
                and self._pending_items >= self.max_pending_items
            ):
                raise ServerOverloadedError(
                    f"backlog {self._pending_items} items >= "
                    f"max_pending_items {self.max_pending_items}"
                )
            self._pending_items += len(items)
        self._q.put((items, key, fut))
        if self._stop.is_set():
            # Racing close(): the worker's shutdown purge may already have
            # drained the queue, so purge again ourselves — a future landing
            # in a dead queue would otherwise block its client for the full
            # request timeout. Purging is idempotent.
            self._purge()
        return fut

    @property
    def pending(self) -> int:
        return self._q.qsize()

    @property
    def pending_items(self) -> int:
        """Items accepted but not yet answered: queued + in flight. This —
        not queue size — is what a graceful drain must wait on (a popped
        batch can sit in ``predict`` for seconds)."""
        with self._pending_lock:
            return self._pending_items + self._inflight_items

    def _move_to_inflight(self, n: int) -> None:
        with self._pending_lock:
            self._pending_items -= n
            self._inflight_items += n

    def close(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout_s)

    # -- worker ---------------------------------------------------------------

    def _drain(self) -> List[Tuple[List, object, Future]]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        total = len(first[0])
        deadline = self.max_wait
        t0 = time.monotonic()
        while total < self.max_items:
            remaining = deadline - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(item)
            total += len(item[0])
        self._move_to_inflight(total)
        return batch

    @staticmethod
    def _resolve(fut: Future, result=None, exc=None) -> None:
        """set_result/set_exception tolerant of a concurrent cancel — the
        check-then-act `if not fut.cancelled()` pattern races with client
        cancels and an InvalidStateError there would kill the worker."""
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except Exception:
            pass  # future already cancelled/resolved

    def _process(self, batch) -> None:
        by_key: dict = {}
        for items, key, fut in batch:
            try:
                by_key.setdefault(key, []).append((items, fut))
            except TypeError as e:
                # Unhashable batching key (e.g. a list passed as a lang).
                # Fail only the offending request — swallowing it in the
                # worker would stall every request coalesced into this
                # drain until their full timeout.
                self._resolve(fut, exc=e)
        for key, group in by_key.items():
            flat = [t for items, _ in group for t in items]
            if self.metrics is not None:
                self.metrics.observe_batch(len(flat))
            try:
                out = self.predict_fn(flat, key)
            except Exception as e:
                for _, fut in group:
                    self._resolve(fut, exc=e)
                continue
            ofs = 0
            for items, fut in group:
                self._resolve(fut, result=out[ofs : ofs + len(items)])
                ofs += len(items)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._drain()
                if batch:
                    try:
                        self._process(batch)
                    finally:
                        with self._pending_lock:
                            self._inflight_items -= sum(
                                len(items) for items, _, _ in batch
                            )
            except BaseException:  # the single worker must never die
                logger.exception("micro-batcher iteration failed")
        # shutdown: fail anything still queued instead of leaving clients
        # blocked until their full request timeout
        self._purge()

    def _purge(self) -> None:
        while True:
            try:
                items, _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            with self._pending_lock:
                self._pending_items -= len(items)
            self._resolve(fut, exc=RuntimeError("server shutting down"))


class EmbeddingServer:
    """HTTP wrapper around per-endpoint MicroBatchers; see module docstring.

    ``pipeline`` is a ``TextToEmbeddingModelPipeline`` (serves /embed);
    optional ``translator`` (``TextToTextModelPipeline``) enables
    /translate, batched per (source_lang, target_lang); optional
    ``speech_pipeline`` (``SpeechToEmbeddingModelPipeline``) enables
    /embed_speech for raw 16 kHz waveforms.
    """

    def __init__(
        self,
        pipeline: Any,
        host: str = "127.0.0.1",
        port: int = 0,
        max_sentences: int = 256,
        max_wait_ms: float = 5.0,
        request_timeout_s: float = 120.0,
        max_pending_sentences: Optional[int] = 4096,
        translator: Any = None,
        speech_pipeline: Any = None,
        warmup: bool = False,
    ):
        if warmup:
            # Run every serving shape once BEFORE accepting requests, on
            # this thread: the first call builds the CUDA kernels (under
            # the lock of ops._build) and sets up the allocator and library
            # handles, which would otherwise land on the first requests.
            # Every enabled endpoint warms: the /embed static buckets,
            # /translate's encoder buckets and one beam decode, and
            # /embed_speech's wave buckets.
            model = getattr(pipeline, "model", None)
            if model is not None and hasattr(model, "warmup"):
                model.warmup()
            if translator is not None and hasattr(translator, "warmup"):
                translator.warmup()
            if speech_pipeline is not None and hasattr(speech_pipeline, "warmup"):
                speech_pipeline.warmup()
        self.metrics = {
            "embed": EndpointMetrics(),
            "translate": EndpointMetrics(),
            "embed_speech": EndpointMetrics(),
        }
        self._pipeline = pipeline
        self.batcher = MicroBatcher(
            lambda texts, lang: pipeline.predict(
                texts, source_lang=lang, batching="static"
            ),
            max_sentences,
            max_wait_ms,
            metrics=self.metrics["embed"],
            max_pending_items=max_pending_sentences,
        )
        self.translate_batcher = (
            MicroBatcher(
                lambda texts, langs: translator.predict(
                    texts, source_lang=langs[0], target_lang=langs[1]
                ),
                max_sentences,
                max_wait_ms,
                metrics=self.metrics["translate"],
                max_pending_items=max_pending_sentences,
            )
            if translator is not None
            else None
        )
        self.speech_batcher = (
            MicroBatcher(
                lambda audios, _key: speech_pipeline.predict(audios),
                max_sentences,
                max_wait_ms,
                metrics=self.metrics["embed_speech"],
                max_pending_items=max_pending_sentences,
            )
            if speech_pipeline is not None
            else None
        )
        self.request_timeout_s = request_timeout_s
        self._draining = threading.Event()
        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every reply carries Content-Length and
            # every POST body is read before replying, so connections are
            # safely reusable (SonarClient relies on this; under 1.0 the
            # socket would be torn down per request).
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route through logging
                logger.debug("http: " + fmt, *args)

            def _reply(self, code: int, payload: dict,
                       retry_after_s: Optional[int] = None) -> None:
                self._last_code = code
                if getattr(self, "_t0", None) is not None:  # POST in flight
                    self._observe(code)
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if retry_after_s is not None:
                    self.send_header("Retry-After", str(retry_after_s))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    status = "draining" if server._draining.is_set() else "ok"
                    self._reply(
                        200, {"status": status, "pending": server.pending}
                    )
                elif self.path == "/metrics":
                    payload = {
                        ep: m.snapshot() for ep, m in server.metrics.items()
                    }
                    enc_stats = getattr(
                        getattr(server._pipeline, "model", None), "stats", None
                    )
                    if enc_stats is not None:
                        # Padded-vs-true token accounting of the encoder:
                        # the device work the static length buckets add.
                        payload["embed"]["encoder"] = enc_stats.snapshot()
                    self._reply(200, payload)
                else:
                    self._reply(404, {"error": "unknown path"})

            def _read_json_object(self) -> dict:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("request body must be a JSON object")
                return req

            def _await(self, fut):
                return fut.result(timeout=server.request_timeout_s)

            def _texts_of(self, req: dict) -> list:
                texts = req["texts"]
                if not isinstance(texts, list) or not all(
                    isinstance(t, str) for t in texts
                ):
                    raise ValueError("'texts' must be a list of strings")
                return texts

            @staticmethod
            def _lang_of(req: dict, field: str, default=None) -> str:
                lang = req.get(field, default)
                if not isinstance(lang, str):
                    # Reject before enqueueing: a non-string lang would be an
                    # unhashable batching key inside the micro-batcher.
                    raise ValueError(f"'{field}' must be a string")
                return lang

            def _observe(self, code: int) -> None:
                # Must run BEFORE the response bytes go out: a client that
                # reads /metrics right after its reply must see this
                # request already counted (a post-reply finally races it).
                if self._ep is not None and not self._observed:
                    self._observed = True
                    server.metrics[self._ep].observe_request(
                        self._n_items,
                        time.monotonic() - self._t0,
                        ok=(code == 200),
                        timeout=(code == 504),
                        shed=(code == 503),
                    )

            def do_POST(self):
                self._t0 = time.monotonic()
                self._ep: Optional[str] = None
                self._n_items = 0
                self._observed = False
                try:
                    self._do_POST_inner()
                finally:
                    # fallback for a handler crash that never replied
                    self._observe(getattr(self, "_last_code", 500))

            _EP_BY_PATH = {
                "/embed": "embed",
                "/translate": "translate",
                "/embed_speech": "embed_speech",
            }

            def _do_POST_inner(self):
                try:
                    if server._draining.is_set():
                        # Graceful shutdown: refuse new work (same contract
                        # as load shedding) while accepted work finishes.
                        # Drain the request body FIRST — replying with
                        # unread bytes in the socket makes the kernel RST
                        # the connection and the client never sees the 503
                        # — and attribute the refusal to its endpoint so
                        # /metrics shows the sheds during a rollout.
                        self.rfile.read(
                            int(self.headers.get("Content-Length", "0"))
                        )
                        self._ep = self._EP_BY_PATH.get(self.path)
                        self._reply(
                            503, {"error": "server is draining"},
                            retry_after_s=1,
                        )
                        return
                    req = self._read_json_object()
                    if self.path == "/embed":
                        self._ep = "embed"
                        texts = self._texts_of(req)
                        self._n_items = len(texts)
                        lang = self._lang_of(req, "lang", "eng_Latn")
                        if not texts:
                            self._reply(200, {"embeddings": [], "dim": 0})
                            return
                        fut = server.batcher.submit(texts, lang)
                        emb = self._await(fut)
                        self._reply(
                            200,
                            {
                                "embeddings": np.asarray(emb, np.float32).tolist(),
                                "dim": int(np.asarray(emb).shape[-1]),
                            },
                        )
                    elif self.path == "/translate":
                        self._ep = "translate"
                        if server.translate_batcher is None:
                            self._reply(404, {"error": "no translator configured"})
                            return
                        texts = self._texts_of(req)
                        self._n_items = len(texts)
                        if "source_lang" not in req or "target_lang" not in req:
                            raise KeyError("source_lang/target_lang required")
                        langs = (self._lang_of(req, "source_lang"),
                                 self._lang_of(req, "target_lang"))
                        if not texts:
                            self._reply(200, {"translations": []})
                            return
                        fut = server.translate_batcher.submit(texts, langs)
                        self._reply(200, {"translations": list(self._await(fut))})
                    elif self.path == "/embed_speech":
                        self._ep = "embed_speech"
                        if server.speech_batcher is None:
                            self._reply(
                                404, {"error": "no speech encoder configured"}
                            )
                            return
                        audios = req["audios"]
                        if isinstance(audios, list):
                            self._n_items = len(audios)
                        if not isinstance(audios, list) or not all(
                            isinstance(a, list) and a for a in audios
                        ):
                            raise ValueError(
                                "'audios' must be a list of non-empty float lists"
                            )
                        if not audios:
                            self._reply(200, {"embeddings": [], "dim": 0})
                            return
                        waves = [np.asarray(a, np.float32) for a in audios]
                        fut = server.speech_batcher.submit(waves)
                        emb = self._await(fut)
                        self._reply(
                            200,
                            {
                                "embeddings": np.asarray(emb, np.float32).tolist(),
                                "dim": int(np.asarray(emb).shape[-1]),
                            },
                        )
                    else:
                        self._reply(404, {"error": "unknown path"})
                except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                except ServerOverloadedError as e:
                    # Load shed at admission: backlog already at the bound.
                    # 503 + Retry-After so well-behaved clients back off
                    # instead of stacking requests into guaranteed 504s.
                    self._reply(
                        503, {"error": f"overloaded: {e}"}, retry_after_s=1
                    )
                except FutureTimeoutError:
                    # Server-side delay (a kernel build, a stalled batch) is not
                    # the client's fault: 504 so well-behaved clients retry.
                    self._reply(504, {"error": "request timed out server-side"})
                except Exception as e:  # unexpected model/runtime errors
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> "EmbeddingServer":
        self._serve_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._serve_thread.start()
        return self

    @property
    def _batchers(self) -> List[MicroBatcher]:
        return [
            b
            for b in (self.batcher, self.translate_batcher, self.speech_batcher)
            if b is not None
        ]

    def drain(self) -> None:
        """Begin graceful shutdown: refuse new POSTs (503 + Retry-After),
        keep processing the already-accepted backlog, and report
        ``{"status": "draining"}`` on /healthz so load balancers pull this
        instance. Call ``stop()`` once ``pending`` reaches zero (or use
        ``stop(drain_timeout_s=...)`` to do both)."""
        self._draining.set()

    @property
    def pending(self) -> int:
        """Items accepted but not yet answered (queued + in predict)."""
        return sum(b.pending_items for b in self._batchers)

    def stop(self, drain_timeout_s: float = 0.0) -> None:
        """Shut down. With ``drain_timeout_s`` > 0: drain first and wait up
        to that long for accepted work — queued AND in-flight — to clear
        before closing (work still outstanding after the timeout is failed
        with 'server shutting down')."""
        deadline = time.monotonic() + drain_timeout_s
        if drain_timeout_s > 0:
            self.drain()
            while self.pending > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=5)
        for b in self._batchers:
            # the drain wait above normally leaves workers idle; if the
            # timeout expired mid-predict, give the worker the remaining
            # budget (min 5 s) to finish before abandoning the join
            b.close(timeout_s=max(5.0, deadline - time.monotonic()))
