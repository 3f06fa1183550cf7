"""The conditional text decoder bound for generation on one device.

``TorchTextDecoder`` is the counterpart of ``JitTextDecoder``
(``sonar_tpu.generation.decoder_runtime``): teacher-forced ``score``,
beam-search ``generate_beam`` / ``generate_beam_async`` +
``materialize_beam`` and top-p / top-k ``generate_sample``, in floating
point or, with ``quantize=True``, with int8 weights.

Beam decoding pads the batch to a power of two with zero rows, as the JAX
runtime does, and runs one device program per batch, as JAX's
``lax.while_loop`` does: on a CUDA device the search's setup (the cache and
the prefix steps) and one step of its body (``generation.beam_search.
beam_step``, which reads nothing back to the host) are captured as CUDA
graphs (``torch.cuda.CUDAGraph``) once per (padded batch, prefix length,
static config, kernel settings; and, for a sequence memory, its padded
length), and a decode replays the setup, then loops
the step on the card until its exit flag says done (a conditional WHILE
node, ``ops.cuda.graph_loop``). A replay launches the kernels its capture
recorded, so the key holds ``ops.gates.kernel_settings()`` read at call
time: a decode inside ``no_cuda_kernels()`` (or after a setter's change)
captures its own program and never replays one captured under other
settings (``_graph_key``). ``generate_beam_async`` queues that, the tail and
the outputs' copies to pinned host memory on the caller's stream and
returns without blocking: a caller encodes and dispatches the next batch
while this one decodes (``TextTranslator.translate_stream``). A capture or
launch that fails raises; nothing falls back to the eager loop. On the CPU
the same body runs eagerly, its exit flag read once per chunk of steps.

Sampling (``generate_sample``) pads the batch to a power of two too and
runs as one device program the same way on a card (``_SampleGraph``: the
setup, then one step of ``generation.sampling.sample_step`` looped on the
card), its Gumbel draw JAX's own (``ops.cuda.gumbel_max``, from the seed's
key words and the device step counter), and returns once its outputs are
on the host, as JAX's does.

Over a mesh of several ranks the rows are split over its ``data`` axis
(padded to a multiple of ``data`` too), each rank decodes its rows with its
share of the heads (and vocabulary), every rank takes the same number of
steps (the exit test is agreed across the world once per chunk: gloo's
collectives cannot be captured, so this path runs eagerly and its handle
is resolved before it is returned), and the rows are gathered over the
data group.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
from sonar_tpu_torch.data.collate import round_up_pow2
from sonar_tpu_torch.device import resolve_device, upload
from sonar_tpu_torch.generation.beam_search import (
    CHUNK_STEPS,
    BeamSearchConfig,
    beam_finish,
    beam_knobs,
    beam_setup,
    beam_step,
    run_chunks,
)
from sonar_tpu_torch.generation.sampling import sample_finish, sample_setup, sample_step
from sonar_tpu_torch.nn.conditional_decoder import ConditionalTransformerDecoder
from sonar_tpu_torch.ops import cuda as kernels
from sonar_tpu_torch.ops.cuda.graph_loop import WhileGraph
from sonar_tpu_torch.ops.cuda.gumbel_max import M32, prng_key
from sonar_tpu_torch.ops.gates import kernel_settings
from sonar_tpu_torch.parallel.comm import any_over
from sonar_tpu_torch.parallel.mesh import Mesh
from sonar_tpu_torch.runtime import (
    POW2_ROWS,
    SCORE_ROWS,
    Counters,
    ModelRuntime,
    row_split,
    split_rows,
)
from sonar_tpu_torch.utils.profiling import span
import torch

# Captured programs a runtime keeps, beam and sampling together (least
# recently used first out): the padded batch sizes 1, 2, 4, ..., 128 of one
# prefix length and config, which the pipelines' warmups capture for a
# batch_size of up to 128. A beam program holds its static KV cache, 2 x L x
# B x H x K x S x Dh values of the model dtype (the basic decoder in bf16 at
# B 32, K 5, S 51: 0.8 GB; fp32 twice that), its state and the [B*K, V] fp32
# logits (164 MB at B 32, K 5, V 256,206), so the sizes up to B hold about
# twice what B's alone does; a sampling program a fifth of the cache, the
# [B, V] log-probabilities and its sort's buffers. The intermediates of all
# of a runtime's graphs share one memory pool.
MAX_GRAPHS = 8

# The lengths a sequence memory (an encoder-decoder model's source, with its
# lengths) is padded to on the card: one captured program, and one cache,
# serves every source up to 128 tokens.
MEMORY_BUCKETS = (128, 256, 512, 1024)


def memory_bucket(length: int) -> int:
    """The padded length of a sequence memory of ``length`` positions (1
    for the SONAR decoder's length-1 memory)."""
    if length == 1:
        return 1
    for b in MEMORY_BUCKETS:
        if length <= b:
            return b
    return length


def _graph_key(*parts: Any) -> Tuple[Any, ...]:
    """A captured program's cache key: ``parts`` and the kernel gates'
    settings now (``ops.gates.kernel_settings``), which its capture bakes
    in."""
    return parts + (kernel_settings(),)


class _BeamHandle:
    """In-flight beam decode (``TorchTextDecoder.generate_beam_async``): the
    host outputs (tokens, scores, lens; padded), the CUDA event behind their
    copies from the card (None once on the host), the true batch size,
    ``settle``, which counts the decode's steps and launches once its step
    count is on the host and returns the device steps it counted (None on
    the CPU), and ``loop``, the loop's CUDA events while recording (None
    otherwise: ``_LoopEvents``). Resolve with
    ``TorchTextDecoder.materialize_beam``."""

    __slots__ = ("outs", "copied", "b", "settle", "loop")

    def __init__(self, outs: Tuple[Any, ...], copied: Any, b: int,
                 settle: Optional[Callable[[], int]] = None, loop: Any = None):
        self.outs, self.copied, self.b, self.settle = outs, copied, b, settle
        self.loop = loop


class _LoopEvents:
    """CUDA events around one launch of a decode's loop on the card, kept
    while recording (``utils.profiling``): ``origin``, recorded first on the
    dispatch's stream at host time ``origin_ns``, places the loop's interval
    (``start`` to ``end``, at the stream boundary: the loop's device time
    alone) on the host's clock. The placement assumes the stream idle at
    the dispatch, as it is between ``predict``'s batches; with batches in
    flight the interval lies early by the wait, its length exact.
    ``dispatch``: the dispatch's span, the new span's parent."""

    def __init__(self, stream: Any, dispatch: Any):
        self.dispatch = dispatch
        self.origin, self.start, self.end = (torch.cuda.Event(enable_timing=True)
                                             for _ in range(3))
        self.origin.record(stream)
        self.origin_ns = time.time_ns()

    def record(self, steps: int) -> None:
        """Once the loop has finished: the ``device.beam_loop`` span."""
        def at(event: Any) -> int:
            return self.origin_ns + int(self.origin.elapsed_time(event) * 1e6)

        self.dispatch.child("device.beam_loop", at(self.start), at(self.end), steps=steps)


def _static_config(config: BeamSearchConfig) -> BeamSearchConfig:
    """The fields a captured program depends on (JAX's ``_beam_static_key``):
    the penalties and ``min_gen_len`` are device scalars filled at each
    call, and only the unk penalty's being nonzero changes the program."""
    return dataclasses.replace(config, len_penalty=1.0, min_gen_len=1, normalize_scores=True,
                               unk_penalty=0.0 if config.unk_penalty == 0 else 1.0)


class _LoopGraph:
    """A captured decode of one key: static inputs (memory [B, S_mem, D],
    S_mem 1 for the SONAR decoder's embedding or a source's padded length
    (``memory_bucket``), with its lengths [B] for a sequence memory, and
    prefix [B, P]; zero and EOS until ``load`` fills them), the setup graph,
    whose outputs are the cache and the loop's state, and ``loop``, which
    steps that state in place on the card until it is done.
    ``setup_launches`` / ``step_launches``: the kernels one replay of the
    setup and one step launch, by ``ops.cuda`` counter."""

    def __init__(self, runtime: "TorchTextDecoder", b_pad: int, prefix_len: int,
                 mem_len: int = 1):
        dev = runtime.device
        self.mem = torch.zeros((b_pad, mem_len, runtime.model.config.model_dim),
                               dtype=torch.float32, device=dev)
        self.mem_lens = (torch.ones((b_pad,), dtype=torch.int32, device=dev) if mem_len > 1
                         else None)
        self.prefix = torch.full((b_pad, prefix_len), runtime.vocab_info.eos_idx,
                                 dtype=torch.long, device=dev)

    def _capture(self, runtime: "TorchTextDecoder", start: Callable, step: Callable,
                 inputs: Tuple[torch.Tensor, ...], pool: Any) -> None:
        """Capture ``start(*inputs)`` and one ``step`` of its state."""
        # One eager setup and step first, on a side stream: they build the
        # kernels, fill the tilings' cache and set up the libraries' handles
        # and workspaces, none of which may happen under capture.
        dev = runtime.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(start(*inputs))
        torch.cuda.current_stream(dev).wait_stream(side)
        runtime.device_steps += self.prefix.shape[1] + 1

        self.setup = torch.cuda.CUDAGraph()
        with kernels.captured_launches() as self.setup_launches, \
                torch.cuda.graph(self.setup, pool=pool, capture_error_mode="thread_local"):
            self.state = start(*inputs)
        body = torch.cuda.CUDAGraph(keep_graph=True)
        with kernels.captured_launches() as self.step_launches, \
                torch.cuda.graph(body, pool=pool, capture_error_mode="thread_local"):
            step(self.state)
        self.loop = WhileGraph(body, self.state.done)

    def load(self, mem: torch.Tensor, prefix_ids: Sequence[int],
             mem_lens: Optional[torch.Tensor] = None) -> None:
        """Copy one call's inputs into the static buffers (zero rows past
        ``mem``'s, as the JAX runtime pads; a sequence memory's positions
        past its length zero too, and a padding row one position long)."""
        b, s = mem.shape[0], mem.shape[1]
        if self.mem_lens is None:
            self.mem[:b].copy_(mem)
        else:
            self.mem[:b, :s].copy_(mem)
            self.mem[:b, s:].zero_()
            self.mem_lens[:b].copy_(mem_lens)
            self.mem_lens[b:].fill_(1)
        self.mem[b:].zero_()
        for j, tok in enumerate(prefix_ids):
            self.prefix[:, j].fill_(int(tok))


class _BeamGraph(_LoopGraph):
    """The captured beam search of one key; its static inputs add the
    penalties, so that one capture serves every value."""

    def __init__(self, runtime: "TorchTextDecoder", b_pad: int, prefix_len: int,
                 config: BeamSearchConfig, pool: Any, mem_len: int = 1):
        super().__init__(runtime, b_pad, prefix_len, mem_len)
        self.knobs = beam_knobs(config, runtime.device)
        start, step = runtime._beam_program(config, prefix_len, self.knobs)
        self._capture(runtime, start, step, (self.mem, self.prefix, self.mem_lens), pool)

    def load(self, mem: torch.Tensor, prefix_ids: Sequence[int], config: BeamSearchConfig,
             mem_lens: Optional[torch.Tensor] = None) -> None:
        super().load(mem, prefix_ids, mem_lens)
        for knob, value in zip(self.knobs, (config.len_penalty, config.unk_penalty,
                                            config.min_gen_len)):
            knob.fill_(value)


class _SampleGraph(_LoopGraph):
    """The captured sampling decode of one key; its static inputs add the
    key words, so that one capture serves every seed."""

    def __init__(self, runtime: "TorchTextDecoder", b_pad: int, prefix_len: int, sampler: Any,
                 max_gen_len: int, min_gen_len: int, pool: Any):
        super().__init__(runtime, b_pad, prefix_len)
        self.key = prng_key(0, runtime.device)
        start, step = runtime._sample_program(sampler, prefix_len, max_gen_len, min_gen_len)
        self._capture(runtime, start, step, (self.mem, self.prefix, self.key), pool)

    def load(self, mem: torch.Tensor, prefix_ids: Sequence[int], seed: int) -> None:
        """The key's second word is the seed mod 2^32; its first stays 0."""
        super().load(mem, prefix_ids)
        self.key[1].fill_(int(seed) & M32)


class TorchTextDecoder(ModelRuntime):
    """A ``ConditionalTransformerDecoder`` on one device (``device=None``
    means the GPU). ``decode_steps`` counts the decoder steps the decodes
    took (prefix steps included; read from each loop's device step
    counter), each of which goes through every layer once;
    ``device_steps`` counts the decoder steps the device ran, which add the
    gated steps of the eager loop's last chunk and the eager steps that
    precede a capture.

    ``quantize`` stores every projection of the decoder layers as int8 with
    per-output-channel scales (a runtime copy; ``nn.core.linear`` then runs
    them with dynamic per-row activation scales); the tied output
    projection stays in floating point. It is off by default, as in the JAX
    package, where int8 decode waits for validation on the published
    checkpoints (``INT8_DECODE_VALIDATED``).

    ``mesh`` (a ``parallel.mesh.Mesh``; ``SINGLE_MESH``, this process
    alone, when None) holds this rank's slice of the weights
    (``shard_params``); every rank takes the global batch and
    returns the whole result (see the module docstring).
    """

    def __init__(self, model: ConditionalTransformerDecoder, quantize: bool = False,
                 device: Any = None, mesh: Optional[Mesh] = None):
        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        # The JAX runtime quantizes the checkpoint layout as it is (the
        # decoder fuses no projections), and so does the port.
        super().__init__(model, self._runtime_params(model), quantize, device, mesh)
        self.decode_steps = 0
        self.device_steps = 0
        self._graphs: "collections.OrderedDict[Any, _LoopGraph]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._pool: Any = None
        self._free: Any = None  # the event after the last captured decode's copies

    @staticmethod
    def _runtime_params(model: Any) -> Any:
        """The weight tree this runtime places (the model's, as it is)."""
        return model.params.tree()

    @property
    def max_target_len(self) -> int:
        return self.model.max_target_len

    @property
    def vocab_info(self) -> Any:
        return self.model.config.vocab_info

    def _tensor(self, x: Any, dtype: torch.dtype) -> torch.Tensor:
        """``x`` on the device, without blocking (``device.upload``)."""
        return upload(torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, dtype=dtype),
                      self.device)

    def _agree(self, flag: bool) -> bool:
        return any_over(flag, self.mesh.world, self.device)

    def _gathered(self, *outs: torch.Tensor, rows: int) -> Tuple[np.ndarray, ...]:
        """The outputs of every data rank in row order, the first ``rows``,
        on the host."""
        return tuple(self.gather(t, rows).cpu().numpy() for t in outs)

    # -- scoring (teacher-forced logits) --------------------------------------

    def score(self, seqs: Any, seq_lens: Any, memory: Any) -> np.ndarray:
        """[B, S] ids, [B] lengths or None, [B, S_mem, D] memory -> [B, S, V]
        fp32 logits."""
        seqs_t = self._tensor(seqs, torch.int32)
        b = seqs_t.shape[0]
        seqs_t = split_rows(seqs_t, self.mesh, SCORE_ROWS)
        lens_t = (None if seq_lens is None else
                  split_rows(self._tensor(seq_lens, torch.int32), self.mesh, SCORE_ROWS))
        mem = split_rows(self._tensor(memory, torch.float32), self.mesh, SCORE_ROWS)
        with self.scope():
            logits = self.model(seqs_t, lens_t, mem)
            return self._gathered(logits, rows=b)[0]

    # -- beam search -----------------------------------------------------------

    def _cap_gen_len(self, config: BeamSearchConfig, prefix_len: int) -> BeamSearchConfig:
        """Cap max_gen_len so the prompt plus the generation fit the position
        table (the reference's prompt-aware cap)."""
        limit = self.max_target_len - prefix_len
        if limit < 1:
            raise ValueError(
                f"prefix of {prefix_len} tokens leaves no room to generate "
                f"(usable target length {self.max_target_len})"
            )
        if config.max_gen_len > limit:
            config = dataclasses.replace(config, max_gen_len=limit)
        return config

    def warmup(self, config: BeamSearchConfig, prefix_len: int = 2,
               batch_sizes: Sequence[int] = (32,), memory_len: int = 1) -> int:
        """Run one beam decode per batch size (this builds the CUDA kernels
        and captures the beam program of each padded batch; ``memory_len``
        > 1: over a sequence memory of that length, for an encoder-decoder
        model); returns the number of batch sizes."""
        eos = self.vocab_info.eos_idx
        d = self.model.config.model_dim
        for b in batch_sizes:
            lens = np.full((b,), memory_len, np.int32) if memory_len > 1 else None
            self.generate_beam(np.zeros((b, memory_len, d), np.float32), [eos] * prefix_len,
                               config, memory_lens=lens)
        return len(tuple(batch_sizes))

    def generate_beam(self, memory: Any, prefix_ids: Sequence[int], config: BeamSearchConfig,
                      memory_lens: Any = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """memory: [B, 1, D] (the SONAR decoder's embedding) or a sequence
        memory [B, S_mem, D] with its lengths ``memory_lens`` [B] (an
        encoder-decoder model's source), numpy or tensors, which may stay
        on the device; returns (tokens [B, K, T], scores [B, K], lens [B,
        K])."""
        return self.materialize_beam(self.generate_beam_async(memory, prefix_ids, config,
                                                              memory_lens))

    def _search_config(self, config: BeamSearchConfig, prefix_len: int) -> BeamSearchConfig:
        # normalize_scores=False is len_penalty 0, as in the JAX runtime.
        config = self._cap_gen_len(config, prefix_len)
        return dataclasses.replace(
            config, normalize_scores=True,
            len_penalty=config.len_penalty if config.normalize_scores else 0.0)

    def _beam_program(self, config: BeamSearchConfig, prefix_len: int,
                      knobs: Optional[Tuple[torch.Tensor, ...]] = None
                      ) -> Tuple[Callable, Callable]:
        """(start(memory [B, S_mem, D], prefix [B, P], memory_lens [B] or
        None) -> BeamState, step(state)): the search's setup and one step of
        its body on this decoder. A length-1 memory is copied to each beam
        (the cache precomputes its cross-attention); a sequence memory, with
        its lengths, is kept once a sentence, its K/V projected once for the
        sentence's beams."""
        vocab, k = self.vocab_info, config.beam_size
        cache_len = prefix_len + config.max_gen_len + 1
        unk = vocab.unk_idx if config.unk_penalty else None

        def step_fn(tokens, cache, ancestry):
            return self.model.step(tokens, cache, ancestry=ancestry, beam_size=k)

        def start(mem, prefix, mem_lens=None):
            if mem_lens is None:
                mem = mem[:, None].expand(-1, k, -1, -1).reshape(-1, *mem.shape[1:])
                cache = self.model.init_cache(mem, cache_len, beam_size=k)
            else:
                cache = self.model.init_cache(mem, cache_len, beam_size=k, memory_lens=mem_lens)
            return beam_setup(step_fn, cache, prefix, vocab.eos_idx, vocab.size, config,
                              pad_idx=vocab.pad_idx or 0, cache_len=cache_len, knobs=knobs)

        def step(state):
            beam_step(state, step_fn, vocab.eos_idx, vocab.size, config, unk)

        return start, step

    def _beam_eager(self, mem: torch.Tensor, prefix_ids: Sequence[int],
                    config: BeamSearchConfig, chunk: int = CHUNK_STEPS,
                    mem_lens: Optional[torch.Tensor] = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The search run eagerly in this thread (the CPU; a mesh of several
        ranks, whose exit test is agreed once a chunk; and, to compare it
        with the captured program, on a card): the same setup, body and
        tail, the exit flag read after every ``chunk`` steps."""
        b = mem.shape[0]
        mem = split_rows(mem, self.mesh, POW2_ROWS)
        if mem_lens is not None:
            mem_lens = split_rows(mem_lens, self.mesh, POW2_ROWS, fill=1)
        prefix = torch.tensor(list(prefix_ids), dtype=torch.long, device=self.device)
        prefix = prefix[None, :].expand(mem.shape[0], -1)
        agree = self._agree if self.mesh.world.size > 1 else None
        with self.scope():
            start, step = self._beam_program(config, len(prefix_ids))
            state = start(mem, prefix, mem_lens)
            ran = run_chunks(state, step, chunk, agree)
            outs = self._gathered(*beam_finish(state, self.vocab_info.eos_idx, config), rows=b)
            self.decode_steps += len(prefix_ids) + int(state.step)
            self.device_steps += len(prefix_ids) + ran
            return outs

    def generate_beam_async(self, memory: Any, prefix_ids: Sequence[int],
                            config: BeamSearchConfig, memory_lens: Any = None) -> _BeamHandle:
        """Dispatch a beam decode and return without blocking: on a card the
        captured program of this batch's key (captured here first if it is
        new) is queued on the caller's stream, behind the work queued there
        so far and this runtime's previous decode, with the tail and the
        outputs' copies to pinned host memory behind a CUDA event. Pipelined
        callers (``TextTranslator.translate_stream``) dispatch batch i + 1
        before materializing batch i. On the CPU, or over a mesh of several
        ranks, the decode runs here and the handle comes back resolved.

        ``memory`` is [B, 1, D], or a sequence memory [B, S_mem, D] with its
        lengths ``memory_lens`` [B] (or a ``SequenceMemory``, which carries
        both); on a card a sequence memory is padded to its
        ``memory_bucket``, which the key holds."""
        config = self._search_config(config, len(prefix_ids))
        if memory_lens is None and hasattr(memory, "lens"):
            memory, memory_lens = memory.seqs, memory.lens
        with span("runtime.dispatch", prefix=len(prefix_ids)) as dispatch:
            cuda = self.device.type == "cuda" and self.mesh.world.size == 1
            stream = torch.cuda.current_stream(self.device) if cuda else None
            loop = _LoopEvents(stream, dispatch) if cuda and dispatch else None
            mem = self._tensor(memory, torch.float32)
            lens = None if memory_lens is None else self._tensor(memory_lens, torch.int32)
            b = mem.shape[0]
            b_pad = round_up_pow2(b)
            mem_len = 1 if lens is None else memory_bucket(mem.shape[1])
            dispatch.set(b_pad=b_pad)
            if not cuda:
                return _BeamHandle(self._beam_eager(mem, prefix_ids, config, mem_lens=lens),
                                   None, b)
            key = _graph_key(b_pad, len(prefix_ids), mem_len, _static_config(config))
            with self._lock, self.scope():
                # The graphs share their static buffers' pool: one decode at a
                # time, whatever stream each caller queues on.
                if self._free is not None:
                    stream.wait_event(self._free)
                graph = self._graph(key, lambda pool: _BeamGraph(self, b_pad, len(prefix_ids),
                                                                 config, pool, mem_len))
                graph.load(mem, prefix_ids, config, lens)
                graph.setup.replay()
                if loop is not None:
                    loop.start.record(stream)
                graph.loop.launch(stream)
                if loop is not None:
                    loop.end.record(stream)
                outs = (beam_finish(graph.state, self.vocab_info.eos_idx, config)
                        + (graph.state.step,))
                host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                             .copy_(t, non_blocking=True) for t in outs)
                self._free = torch.cuda.Event()
                self._free.record(stream)
                settle = functools.partial(self._settle, graph, len(prefix_ids), host[3])
                return _BeamHandle(host[:3], self._free, b, settle, loop)

    def _graph(self, key: Any, capture: Callable[[Any], _LoopGraph]) -> _LoopGraph:
        """The captured program of ``key``, ``capture(pool)`` now if it is
        new."""
        if key in self._graphs:
            self._graphs.move_to_end(key)
            return self._graphs[key]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with span("runtime.capture", key=repr(key)):
            graph = capture(self._pool)
        self._graphs[key] = graph
        while len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return graph

    def _settle(self, graph: _LoopGraph, prefix_len: int, step: torch.Tensor) -> int:
        """Count a captured decode once its step count is on the host: the
        steps, and the launches of one setup and of ``step`` body steps.
        Returns the device steps counted."""
        steps = int(step)
        with self._lock:
            self.decode_steps += prefix_len + steps
            self.device_steps += prefix_len + steps
            kernels.add_launches(graph.setup_launches)
            kernels.add_launches(graph.step_launches, steps)
        return prefix_len + steps

    @staticmethod
    def materialize_beam(handle: _BeamHandle) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block on a ``generate_beam_async`` handle -> host (tokens, scores,
        lens), padding rows trimmed."""
        with span("runtime.materialize", rows=handle.b):
            if handle.copied is not None:
                handle.copied.synchronize()
            settle, handle.settle = handle.settle, None
            loop, handle.loop = handle.loop, None
            if settle is not None:
                steps = settle()
                if loop is not None:
                    loop.record(steps)
            return tuple(np.array(np.asarray(t)[: handle.b]) for t in handle.outs)

    # -- sampling ---------------------------------------------------------------

    def _sample_program(self, sampler: Any, prefix_len: int, max_gen_len: int,
                        min_gen_len: int, row0: int = 0, noise: Optional[Callable] = None
                        ) -> Tuple[Callable, Callable]:
        """(start(memory [B, 1, D], prefix [B, P], key [2]) -> SampleState,
        step(state)): the sampling loop's setup and one step of its body on
        this decoder; ``row0`` the first row's global index."""
        vocab = self.vocab_info
        cache_len = prefix_len + max_gen_len + 1
        pad = vocab.pad_idx or 0

        def step_fn(tokens, cache):
            logits, cache = self.model.step(tokens, cache)
            return torch.log_softmax(logits.float(), dim=-1), cache

        def start(mem, prefix, key):
            # Standard strides: a memory of stride 0 on its size-1 axis (a
            # numpy row slice with an axis added) takes another fp32 GEMM.
            cache = self.model.init_cache(mem.clone(memory_format=torch.contiguous_format),
                                          cache_len)
            return sample_setup(step_fn, cache, prefix, vocab.size, max_gen_len, key, pad)

        def step(state):
            sample_step(state, step_fn, vocab.eos_idx, sampler, max_gen_len, min_gen_len, pad,
                        row0, noise)

        return start, step

    def _sample_eager(self, mem: torch.Tensor, prefix_ids: Sequence[int], sampler: Any,
                      max_gen_len: int, min_gen_len: int = 1, seed: int = 0,
                      noise: Optional[Callable] = None, chunk: int = CHUNK_STEPS
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The sampling decode run eagerly in this thread (the CPU; a mesh of
        several ranks; a ``noise`` hook; and, to compare it with the captured
        program, on a card): the same setup, body and tail on the same
        padded batch, the exit flag read after every ``chunk`` steps (every
        step with a hook). Each rank draws the rows it holds of the padded
        batch; a hook is asked for the whole padded batch's draw and each
        rank reads its rows."""
        b = mem.shape[0]
        b_pad, rows = row_split(b, self.mesh, POW2_ROWS)
        mem = split_rows(mem, self.mesh, POW2_ROWS)
        if noise is not None and self.mesh.data > 1:
            draw = noise

            def noise(step: int, shape: Tuple[int, ...]) -> torch.Tensor:
                return torch.as_tensor(draw(step, (b_pad,) + tuple(shape[1:])),
                                       dtype=torch.float32, device=self.device)[rows]

        prefix = torch.tensor(list(prefix_ids), dtype=torch.long, device=self.device)
        prefix = prefix[None, :].expand(mem.shape[0], -1)
        agree = self._agree if self.mesh.world.size > 1 else None
        with self.scope():
            start, step = self._sample_program(sampler, len(prefix_ids), max_gen_len,
                                               min_gen_len, rows.start, noise)
            state = start(mem, prefix, prng_key(seed, self.device))
            ran = run_chunks(state, step, 1 if noise is not None else chunk, agree)
            outs = self._gathered(*sample_finish(state, self.vocab_info.eos_idx, sampler),
                                  rows=b)
            self.decode_steps += len(prefix_ids) + int(state.step)
            self.device_steps += len(prefix_ids) + ran
            return outs

    def generate_sample(self, memory: Any, prefix_ids: Sequence[int], sampler: Any,
                        max_gen_len: int, min_gen_len: int = 1, seed: int = 0,
                        noise: Optional[Callable] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """memory: [B, 1, D] (numpy or a tensor); returns (tokens [B, T],
        scores [B], lens [B]) of one sampled hypothesis per row.

        The batch is padded with zero rows to a power of two (and a multiple
        of ``data``), and each step draws JAX's Gumbel noise of
        ``fold_in(PRNGKey(seed), step)`` over the padded batch
        (``ops.cuda.gumbel_max``), so the same seed samples the tokens
        ``JitTextDecoder.generate_sample`` samples. ``noise(step, (B_pad,
        V))``, when given, replaces that draw (the tests' hook); the body
        then runs eagerly, reading the step back once a step. On a card,
        with one rank and no hook, the captured program of this key
        (captured here first if it is new; any seed) runs the loop on the
        card; this call returns once its outputs are on the host."""
        # Same prompt-aware cap as the beam path.
        max_gen_len = min(max_gen_len, self.max_target_len - len(prefix_ids))
        if max_gen_len < 1:
            raise ValueError(
                f"prefix of {len(prefix_ids)} tokens leaves no room to generate "
                f"(usable target length {self.max_target_len})"
            )
        mem = self._tensor(memory, torch.float32)
        b = mem.shape[0]
        if self.device.type != "cuda" or self.mesh.world.size > 1 or noise is not None:
            return self._sample_eager(mem, prefix_ids, sampler, max_gen_len, min_gen_len, seed,
                                      noise)
        b_pad = round_up_pow2(b)
        key = _graph_key("sample", b_pad, len(prefix_ids), sampler, max_gen_len, min_gen_len)
        stream = torch.cuda.current_stream(self.device)
        with self._lock, self.scope():
            if self._free is not None:
                stream.wait_event(self._free)
            graph = self._graph(key, lambda pool: _SampleGraph(
                self, b_pad, len(prefix_ids), sampler, max_gen_len, min_gen_len, pool))
            graph.load(mem, prefix_ids, seed)
            graph.setup.replay()
            graph.loop.launch(stream)
            outs = sample_finish(graph.state, self.vocab_info.eos_idx, sampler)
            host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                         .copy_(t, non_blocking=True) for t in outs + (graph.state.step,))
            self._free = copied = torch.cuda.Event()
            copied.record(stream)
        copied.synchronize()
        self._settle(graph, len(prefix_ids), host[3])
        return tuple(np.array(t.numpy()[:b]) for t in host[:3])


class TorchEncoderDecoder(TorchTextDecoder):
    """An encoder-decoder translation model (``models.nllb_moe.NllbMoeModel``)
    bound on one device: the decoder's runtime (beam search through the
    captured loop, over a sequence memory kept once a sentence) and its
    encoder's (``encode_batch``, as ``TorchTextEncoder`` has it, which
    returns the [B, S, D] memory and its lengths, ``SequenceMemory``). The
    encoder's self-attention projections are fused into one (``fuse_qkv``,
    a runtime copy; the decoder's stay split for its cache). ``stats``
    counts the batches encoded and their tokens, true and padded."""

    def __init__(self, model: Any, device: Any = None, mesh: Optional[Mesh] = None):
        super().__init__(model, quantize=False, device=device, mesh=mesh)
        self.stats = Counters("batches", "true_tokens", "padded_tokens",
                              true="true_tokens", padded="padded_tokens")

    @staticmethod
    def _runtime_params(model: Any) -> Any:
        from sonar_tpu_torch.nn.transformer import fuse_qkv

        params = model.params.tree()
        return dict(params, encoder=fuse_qkv(params["encoder"]))

    @property
    def max_source_len(self) -> int:
        return self.model.max_source_len

    def encode_batch(self, batch: Any, materialize: bool = True) -> Any:
        """The memory of a ``SequenceBatch``'s real rows and their lengths (a
        ``SequenceMemory``), on the device, or on the host with
        ``materialize``."""
        from sonar_tpu_torch.models.nllb_moe.model import SequenceMemory

        lens = np.asarray(batch.seq_lens)
        tokens = int(lens[: batch.true_batch].sum())
        self.stats.add(batches=1, true_tokens=tokens, padded_tokens=np.prod(batch.seqs.shape))
        with span("runtime.encode_memory", rows=batch.true_batch, length=batch.seqs.shape[1],
                  tokens=tokens):
            seqs_t = self._tensor(np.ascontiguousarray(batch.seqs, np.int32), torch.int32)
            lens_t = self._tensor(np.ascontiguousarray(lens, np.int32), torch.int32)
            with self.scope():
                memory = self.model.encode(seqs_t, lens_t)[: batch.true_batch]
            lens_t = lens_t[: batch.true_batch]
        if materialize:
            return SequenceMemory(self.to_host(memory), lens_t.cpu().numpy())
        return SequenceMemory(memory, lens_t)
