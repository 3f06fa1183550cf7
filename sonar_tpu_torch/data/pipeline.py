"""Host-side data-pipeline engine.

TPU-native replacement for fairseq2n's C++ DataPipeline (used by the
reference at ``sonar/inference_pipelines/text.py:231-247`` and
``speech.py:100-147``). Same combinator surface:

``read_sequence`` / ``read_text`` -> ``.map(fn, num_parallel_calls=)`` /
``.bucket(n)`` / ``.dynamic_bucket(max_cost, cost_fn, ...)`` /
``.prefetch(n)`` / ``.skip(n)`` / ``.filter(fn)`` -> ``.and_return()``.

Implementation notes:
- ``map(num_parallel_calls=k)`` uses a thread pool with a bounded in-flight
  window, preserving order (fairseq2n semantics). CPU-bound tokenization
  releases the GIL rarely, but audio decode / numpy work does; the native
  C++ helpers (``sonar_tpu_torch/native``) release the GIL for their hot loops.
- ``prefetch(n)`` runs the upstream iterator on a daemon thread into a
  bounded queue — this is the host/device overlap point: batches are
  prepared while the TPU computes the previous step.
- Workers (``map``'s pool, ``prefetch``'s thread) run in a copy of the
  caller's ``contextvars`` context, so their spans
  (``utils.profiling.span``) carry the caller's request. ``prefetch``
  records the consumer's wait on an empty queue (``pipeline.wait``, its
  ``cause`` the producer's innermost span then) and the producer's on a
  full one (``pipeline.backpressure``).
- Everything is lazy; iteration starts on ``__iter__``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import contextvars
from pathlib import Path
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, List, Optional, Sequence, Union

from sonar_tpu_torch.utils.profiling import innermost, span


class DataPipelineBuilder:
    def __init__(self, source: Callable[[], Iterator]):
        self._source = source

    # -- combinators ---------------------------------------------------------

    def map(
        self,
        fn: Callable,
        num_parallel_calls: int = 1,
        selector: Optional[str] = None,
    ) -> "DataPipelineBuilder":
        """Apply ``fn`` per element; ``selector`` maps a dict field in place
        (fairseq2 selector strings like ``"fbank"`` — nested via dots)."""
        applied = fn if selector is None else _selector_fn(fn, selector)
        src = self._source
        if num_parallel_calls <= 1:
            def gen():
                for item in src():
                    yield applied(item)
        else:
            def gen():
                with ThreadPoolExecutor(max_workers=num_parallel_calls) as pool:
                    pending: "queue.Queue" = queue.Queue()
                    it = src()
                    n_inflight = 0
                    window = num_parallel_calls * 2
                    try:
                        while True:
                            while n_inflight < window:
                                try:
                                    item = next(it)
                                except StopIteration:
                                    break
                                pending.put(pool.submit(contextvars.copy_context().run,
                                                        applied, item))
                                n_inflight += 1
                            if n_inflight == 0:
                                break
                            yield pending.get().result()
                            n_inflight -= 1
                    finally:
                        while n_inflight:
                            pending.get().cancel()
                            n_inflight -= 1
        return DataPipelineBuilder(gen)

    def map_batched(
        self, fn: Callable[[List[Any]], Sequence[Any]], batch_size: int = 1024
    ) -> "DataPipelineBuilder":
        """Apply ``fn`` to chunks of up to ``batch_size`` elements and yield
        its results element-wise. The streaming equivalent of
        ``map(fn_single)`` for functions with an efficient batch form —
        e.g. the native tokenizer's ``encode_batch``, which normalizes and
        Viterbi-segments a whole chunk in ONE GIL-releasing C++ call with
        an internal thread pool."""
        src = self._source

        def run(buf):
            out = list(fn(buf))
            if len(out) != len(buf):
                # A batch fn that drops/merges elements would silently
                # misalign every downstream element (order restoration
                # pairs embeddings with the wrong inputs).
                raise ValueError(
                    f"map_batched fn returned {len(out)} results for a "
                    f"chunk of {len(buf)} elements"
                )
            return out

        def gen():
            buf: List[Any] = []
            for item in src():
                buf.append(item)
                if len(buf) == batch_size:
                    yield from run(buf)
                    buf = []
            if buf:
                yield from run(buf)

        return DataPipelineBuilder(gen)

    def filter(self, pred: Callable[[Any], bool]) -> "DataPipelineBuilder":
        src = self._source

        def gen():
            for item in src():
                if pred(item):
                    yield item

        return DataPipelineBuilder(gen)

    def skip(self, n: int) -> "DataPipelineBuilder":
        src = self._source

        def gen():
            it = src()
            for _ in range(n):
                next(it, None)
            yield from it

        return DataPipelineBuilder(gen)

    def take(self, n: int) -> "DataPipelineBuilder":
        src = self._source

        def gen():
            it = src()
            for _ in range(n):
                try:
                    yield next(it)
                except StopIteration:
                    return

        return DataPipelineBuilder(gen)

    def bucket(self, bucket_size: int, drop_remainder: bool = False) -> "DataPipelineBuilder":
        """Group consecutive elements into lists of ``bucket_size``."""
        src = self._source

        def gen():
            buf: List[Any] = []
            for item in src():
                buf.append(item)
                if len(buf) == bucket_size:
                    yield buf
                    buf = []
            if buf and not drop_remainder:
                yield buf

        return DataPipelineBuilder(gen)

    def dynamic_bucket(
        self,
        max_cost: float,
        cost_fn: Callable[[Any], float],
        min_num_examples: int = 1,
        max_num_examples: Optional[int] = None,
        drop_remainder: bool = False,
    ) -> "DataPipelineBuilder":
        """Token-budget bucketing (fairseq2n ``dynamic_bucket`` semantics):
        accumulate elements while total cost <= max_cost, respecting
        min/max example counts."""
        src = self._source

        def gen():
            buf: List[Any] = []
            cost = 0.0
            for item in src():
                c = float(cost_fn(item))
                if buf and (
                    cost + c > max_cost
                    or (max_num_examples is not None and len(buf) >= max_num_examples)
                ):
                    if len(buf) >= min_num_examples:
                        yield buf
                        buf, cost = [], 0.0
                buf.append(item)
                cost += c
            if buf and not drop_remainder:
                yield buf

        return DataPipelineBuilder(gen)

    def prefetch(self, num_prefetch: int) -> "DataPipelineBuilder":
        if num_prefetch <= 0:
            return self
        src = self._source

        def gen():
            q: "queue.Queue" = queue.Queue(maxsize=num_prefetch)
            _SENTINEL = object()
            error: List[BaseException] = []
            # Set when the consumer abandons the iterator (GeneratorExit):
            # without it the worker would block on q.put forever once the
            # queue fills — a thread + upstream-resource leak per abandoned
            # pipeline in a long-lived process.
            stop = threading.Event()

            def put(item: Any) -> bool:
                """Queue ``item``; False once the consumer has left."""
                try:
                    q.put_nowait(item)
                except queue.Full:
                    with span("pipeline.backpressure"):
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                return not stop.is_set()

            def worker():
                try:
                    for item in src():
                        if not put(item):
                            return
                except BaseException as e:  # propagate to consumer
                    error.append(e)
                finally:
                    # blocking-with-stop: the queue may be momentarily full,
                    # but the sentinel MUST arrive unless the consumer left
                    while not stop.is_set():
                        try:
                            q.put(_SENTINEL, timeout=0.1)
                            break
                        except queue.Full:
                            continue

            t = threading.Thread(target=contextvars.copy_context().run, args=(worker,),
                                 daemon=True)
            t.start()
            try:
                while True:
                    try:
                        item = q.get_nowait()
                    except queue.Empty:
                        with span("pipeline.wait", cause=innermost(t)):
                            item = q.get()
                    if item is _SENTINEL:
                        if error:
                            raise error[0]
                        return
                    yield item
            finally:
                stop.set()

        return DataPipelineBuilder(gen)

    # -- termination ----------------------------------------------------------

    def and_return(self) -> "DataPipeline":
        return DataPipeline(self._source)


class DataPipeline(Iterable):
    def __init__(self, source: Callable[[], Iterator]):
        self._source = source

    def __iter__(self) -> Iterator:
        return self._source()


def _selector_fn(fn: Callable, selector: str) -> Callable:
    keys = selector.split(".")

    def apply(item):
        target = item
        for k in keys[:-1]:
            target = target[k]
        target[keys[-1]] = fn(target[keys[-1]])
        return item

    return apply


def read_sequence(seq: Sequence) -> DataPipelineBuilder:
    return DataPipelineBuilder(lambda: iter(seq))


def read_iterator(make_iter: Callable[[], Iterator]) -> DataPipelineBuilder:
    return DataPipelineBuilder(make_iter)


def read_text(path: Union[str, Path], rtrim: bool = True) -> DataPipelineBuilder:
    """Yield lines of a text file (newline-stripped, like fairseq2 read_text)."""
    p = Path(path)

    def gen():
        with p.open("r", encoding="utf-8") as f:
            for line in f:
                yield line.rstrip("\r\n") if rtrim else line

    return DataPipelineBuilder(gen)
