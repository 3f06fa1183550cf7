"""Stdlib HTTP client for ``sonar_tpu_torch.serving.EmbeddingServer``.

The port's copy of ``sonar_tpu.client``; it speaks to either package's
server, which share one protocol.

Completes the serving story: the server sheds load with HTTP 503 +
``Retry-After`` (see ``serving.py``), and this client is the reference
implementation of a well-behaved caller — it honors ``Retry-After`` with
bounded exponential backoff, retries server-side timeouts (504), chunks
large inputs so no single request monopolizes the batcher, and reuses one
HTTP connection per client. Zero third-party dependencies.

Names follow the server's endpoints.

    client = SonarClient("127.0.0.1", 8000)
    embs = client.embed(["hello world", ...], lang="eng_Latn")   # np.ndarray
    texts = client.translate(["..."], source_lang="eng_Latn",
                             target_lang="fra_Latn")
    embs = client.embed_speech([waveform_floats, ...])
    client.healthz()   # {"status": "ok", "pending": N}
    client.metrics()   # per-endpoint counters/percentiles
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def _retry_after_seconds(headers: Dict[str, str]) -> float:
    """Parse Retry-After defensively: delta-seconds (our server), the
    RFC 7231 HTTP-date form (proxies may rewrite to it), any header case
    (HTTP/2 hops lowercase names). Unparseable -> 0 (fall back to our own
    backoff) — a malformed header must never crash the retry loop."""
    value = next(
        (v for k, v in headers.items() if k.lower() == "retry-after"), ""
    ).strip()
    if not value:
        return 0.0
    try:
        return max(0.0, float(value))
    except ValueError:
        pass
    try:
        from email.utils import parsedate_to_datetime

        dt = parsedate_to_datetime(value)
        return max(0.0, dt.timestamp() - time.time())
    except (ValueError, TypeError, OverflowError):
        return 0.0


class ServerError(RuntimeError):
    """Non-retryable server reply (4xx, or retries exhausted)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class SonarClient:
    """Blocking client with retry/backoff for one EmbeddingServer.

    ``max_retries`` bounds retry attempts for retryable statuses (503
    overload — waits the server's ``Retry-After``; 504 server-side timeout
    — retries immediately once backoff allows; connection resets). 4xx
    replies raise ``ServerError`` without retrying: the request itself is
    bad. ``chunk_size`` splits large inputs into sequential requests so a
    bulk caller shares the micro-batcher fairly with interactive traffic.

    Not thread-safe (one reused ``HTTPConnection``): use one client per
    thread; the server coalesces concurrent clients into shared batches.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8000,
        timeout_s: float = 300.0,
        max_retries: int = 5,
        backoff_s: float = 0.2,
        max_backoff_s: float = 10.0,
        chunk_size: int = 1024,
    ):
        self.host = host
        self.port = port
        self.timeout_s = timeout_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.chunk_size = chunk_size
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- transport ----------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "SonarClient":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def _request_once(
        self, method: str, path: str, payload: Optional[dict]
    ) -> tuple:
        conn = self._connection()
        body = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"} if body else {}
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, ConnectionError, OSError):
            self.close()  # stale keep-alive connection: force a fresh one
            raise
        return resp.status, dict(resp.headers), data

    def _request(self, method: str, path: str, payload: Optional[dict]) -> dict:
        delay = self.backoff_s
        last: tuple = (0, "no attempt made")
        for attempt in range(self.max_retries + 1):
            try:
                status, headers, data = self._request_once(method, path, payload)
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                last = (0, f"connection error: {e}")
                if attempt == self.max_retries:
                    break
                time.sleep(min(delay, self.max_backoff_s))
                delay *= 2
                continue
            if status == 200:
                return json.loads(data)
            try:
                message = json.loads(data).get("error", data.decode("utf-8", "replace"))
            except (ValueError, AttributeError):
                message = data.decode("utf-8", "replace")
            if status in (503, 504):
                last = (status, message)
                if attempt == self.max_retries:
                    break
                # 503 carries the server's own pacing hint; take the larger
                # of it and our backoff so repeated sheds still decelerate.
                time.sleep(
                    min(
                        max(delay, _retry_after_seconds(headers)),
                        self.max_backoff_s,
                    )
                )
                delay *= 2
                continue
            raise ServerError(status, message)  # 4xx etc.: not retryable
        raise ServerError(last[0], f"retries exhausted: {last[1]}")

    # -- endpoints ----------------------------------------------------------

    def healthz(self) -> Dict[str, Any]:
        return self._request("GET", "/healthz", None)

    def metrics(self) -> Dict[str, Any]:
        return self._request("GET", "/metrics", None)

    def embed(self, texts: Sequence[str], lang: str = "eng_Latn") -> np.ndarray:
        """Text -> [N, D] float32 embeddings (chunked, order-preserving).
        Empty input returns shape (0, 0): the embedding dim is a server-side
        model property the client cannot know without a request."""
        parts: List[np.ndarray] = []
        texts = list(texts)
        for i in range(0, len(texts), self.chunk_size):
            out = self._request(
                "POST", "/embed",
                {"texts": texts[i : i + self.chunk_size], "lang": lang},
            )
            parts.append(np.asarray(out["embeddings"], np.float32))
        if not parts:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(parts, axis=0)

    def translate(
        self, texts: Sequence[str], source_lang: str, target_lang: str
    ) -> List[str]:
        out: List[str] = []
        texts = list(texts)
        for i in range(0, len(texts), self.chunk_size):
            resp = self._request(
                "POST", "/translate",
                {
                    "texts": texts[i : i + self.chunk_size],
                    "source_lang": source_lang,
                    "target_lang": target_lang,
                },
            )
            out.extend(resp["translations"])
        return out

    def embed_speech(self, waveforms: Sequence[Sequence[float]]) -> np.ndarray:
        """Raw 16 kHz waveforms -> [N, D] float32 embeddings."""
        parts: List[np.ndarray] = []
        waves = [list(map(float, w)) for w in waveforms]
        for i in range(0, len(waves), self.chunk_size):
            out = self._request(
                "POST", "/embed_speech", {"audios": waves[i : i + self.chunk_size]}
            )
            parts.append(np.asarray(out["embeddings"], np.float32))
        if not parts:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(parts, axis=0)
