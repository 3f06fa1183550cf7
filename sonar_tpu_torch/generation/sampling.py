"""Sampling generation, top-p and top-k (``sonar_tpu.generation.sampling``).

One hypothesis per input, generated against the same preallocated KV cache
as beam search, in the plain decode mode. ``sample_lax`` is JAX's
``lax.while_loop`` in three parts: ``sample_setup`` (the prefix steps and
the state), ``sample_step`` (the body, which reads nothing back to the
host: the step counter and the exit test are device tensors, and every
update is gated by the device flag ``done``, JAX's ``cond`` negated) and
``sample_finish`` (the force-close tail). On a card ``TorchTextDecoder``
captures the body in a CUDA graph and loops it on the device until
``done``; the eager loop (``beam_search.run_chunks``) runs the same body and
reads the flag once per chunk of steps (the CPU, a mesh of several ranks).

Random numbers: ``jax.random.categorical`` draws ``argmax(logits +
gumbel(key, logits.shape))`` with the key ``fold_in(PRNGKey(seed), step)``.
The port computes the same draw from the key's words and the device step
counter (``ops.cuda.gumbel_max``: a CUDA kernel on the card, its plain
version on the CPU and inside ``no_cuda_kernels()``, the same noise), so
the same seed samples the same tokens in both packages. A ``noise(step,
shape)`` callable given to the loop replaces the draw (the tests' hook); it
takes the step as a host int, so the body then reads the step back once a
step and is never captured.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from sonar_tpu_torch.generation.beam_search import CHUNK_STEPS, run_chunks
from sonar_tpu_torch.ops.cuda.gumbel_max import gumbel_max, gumbel_max_plain
from sonar_tpu_torch.ops.gates import kernels_allowed
from sonar_tpu_torch.ops.topk import exact_top_k_wide
import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class TopPSampler:
    p: float = 0.9
    temperature: float = 1.0
    # Prefilter to the top-N candidates before the cumulative-mass scan (a
    # full sort of a 256k vocabulary is the step's largest cost); a
    # distribution whose top-p nucleus fits in N is unaffected. 0 = exact.
    max_candidates: int = 0

    def filter_logprobs(self, logprobs: torch.Tensor) -> torch.Tensor:
        """Keep the smallest prefix of the sorted distribution with mass >= p."""
        if 0 < self.max_candidates < logprobs.shape[-1]:
            sorted_lp, _ = exact_top_k_wide(logprobs, self.max_candidates)
        else:
            sorted_lp = torch.sort(logprobs, dim=-1, descending=True).values
        probs = torch.exp(sorted_lp)
        cum = torch.cumsum(probs, dim=-1)
        # Position i is kept if the cumulative mass before it is < p.
        keep_sorted = (cum - probs) < self.p
        threshold = torch.where(keep_sorted, sorted_lp, torch.inf).amin(dim=-1, keepdim=True)
        return torch.where(logprobs >= threshold, logprobs, NEG_INF)


@dataclass(frozen=True)
class TopKSampler:
    k: int = 10
    temperature: float = 1.0

    def filter_logprobs(self, logprobs: torch.Tensor) -> torch.Tensor:
        top_lp, _ = exact_top_k_wide(logprobs, self.k)
        return torch.where(logprobs >= top_lp[..., -1:], logprobs, NEG_INF)


@dataclass
class SampleState:
    """The loop's carry on the device (JAX's ``SampleState`` with the last
    log-probabilities, the exit flag and the key), updated in place by
    ``sample_step``: its tensors can be the static buffers of a CUDA graph.
    ``done``: no further step can change any output (the step limit is
    reached or every row is finished)."""

    tokens: torch.Tensor    # [B, T] int64
    scores: torch.Tensor    # [B] fp32
    lens: torch.Tensor      # [B] int64
    finished: torch.Tensor  # [B] bool
    step: torch.Tensor      # 0-d int64: steps taken
    logprobs: torch.Tensor  # [B, V] fp32 of the next token
    done: torch.Tensor      # 0-d bool
    key: torch.Tensor       # [2] int64: PRNGKey(seed)'s uint32 words
    cache: Any


def _tempered(logprobs: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logprobs
    return torch.log_softmax(logprobs / temperature, dim=-1)


def sample_setup(
    step_fn: Callable,
    cache: Any,
    prefix_tokens: torch.Tensor,
    vocab_size: int,
    max_gen_len: int,
    key: torch.Tensor,
    pad_idx: int = 0,
) -> SampleState:
    """Force the prefix through the decoder and build the loop's state.
    ``key``: ``prng_key(seed)`` on the device, or a tensor the caller fills."""
    dev = prefix_tokens.device
    B, P = prefix_tokens.shape
    logprobs = torch.zeros((B, vocab_size), dtype=torch.float32, device=dev)
    for i in range(P):
        logprobs, cache = step_fn(prefix_tokens[:, i], cache)
    return SampleState(
        tokens=torch.full((B, max_gen_len + 1), pad_idx, dtype=torch.long, device=dev),
        scores=torch.zeros((B,), dtype=torch.float32, device=dev),
        lens=torch.zeros((B,), dtype=torch.long, device=dev),
        finished=torch.zeros((B,), dtype=torch.bool, device=dev),
        step=torch.zeros((), dtype=torch.long, device=dev),
        logprobs=logprobs,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        key=key,
        cache=cache,
    )


def sample_step(
    state: SampleState,
    step_fn: Callable,
    eos_idx: int,
    sampler: Any,
    max_gen_len: int,
    min_gen_len: int = 1,
    pad_idx: int = 0,
    row0: int = 0,
    noise: Optional[Callable[[int, Tuple[int, ...]], Any]] = None,
) -> None:
    """One iteration of JAX's ``while_loop`` body, in place, reading nothing
    back to the host (but for ``noise``, which takes the step as an int).
    Every update is gated by ``~state.done``: a step taken once the state is
    done still runs the decoder but leaves every output as it was, and the
    state stays done. ``row0``: the global index of the state's first row
    (the draw's rows)."""
    go = ~state.done
    step, finished = state.step, state.finished
    lp = _tempered(state.logprobs, getattr(sampler, "temperature", 1.0))
    if min_gen_len > 1:
        lp = lp.clone()
        lp[:, eos_idx] = torch.where(step + 1 < min_gen_len, NEG_INF, lp[:, eos_idx])
    filtered = sampler.filter_logprobs(lp)
    if noise is None:
        draw = gumbel_max if kernels_allowed() else gumbel_max_plain
        tok = draw(filtered, state.key, step, row0)
    else:
        g = torch.as_tensor(noise(int(step), tuple(filtered.shape)), dtype=torch.float32,
                            device=filtered.device)
        tok = torch.argmax(filtered + g, dim=-1)
    tok = torch.where(finished, pad_idx, tok)
    chosen = torch.gather(lp, 1, tok[:, None])[:, 0]
    at = step.reshape(1, 1).expand(tok.shape[0], 1)
    column = torch.where(finished, torch.gather(state.tokens, 1, at)[:, 0], tok)
    scores = torch.where(finished, state.scores, state.scores + chosen)
    lens = torch.where(finished, state.lens, step + 1)
    now_finished = finished | (tok == eos_idx)
    logprobs, state.cache = step_fn(tok, state.cache)
    tokens = state.tokens.scatter(1, at, column[:, None])
    for dst, new in ((state.tokens, tokens), (state.scores, scores), (state.lens, lens),
                     (state.finished, now_finished), (state.logprobs, logprobs)):
        torch.where(go, new, dst, out=dst)
    state.step.add_(go.long())
    state.done.copy_((state.step >= max_gen_len) | state.finished.all())


def sample_finish(state: SampleState, eos_idx: int, sampler: Any
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Force-close unfinished rows with EOS, charging the model's EOS logprob
    of the last step on the same temperature scale as every score term ->
    (tokens [B, T] int32, scores [B], lens [B] int32)."""
    T = state.tokens.shape[1]
    final = _tempered(state.logprobs, getattr(sampler, "temperature", 1.0))
    unfinished = ~state.finished
    positions = torch.arange(T, device=state.tokens.device)
    tokens = torch.where((positions[None, :] == torch.clamp(state.step, max=T - 1))
                         & unfinished[:, None], eos_idx, state.tokens)
    scores = torch.where(unfinished, state.scores + final[:, eos_idx], state.scores)
    lens = torch.where(unfinished, state.step + 1, state.lens)
    return tokens.to(torch.int32), scores, lens.to(torch.int32)


def sample_lax(
    step_fn: Callable,
    cache: Any,
    prefix_tokens: torch.Tensor,
    eos_idx: int,
    vocab_size: int,
    sampler: Any,
    rng: torch.Tensor,
    max_gen_len: int,
    min_gen_len: int = 1,
    pad_idx: int = 0,
    noise: Optional[Callable[[int, Tuple[int, ...]], Any]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ancestral sampling, run eagerly: setup, the body until
    ``done`` (read once per chunk of steps; once a step with ``noise``),
    the tail.

    step_fn(tokens [B], cache) -> (fp32 log-probabilities [B, V], cache).
    prefix_tokens: [B, P] forced prompt. rng: ``prng_key(seed)`` on the
    device (JAX's ``PRNGKey(seed)``). Each step samples ``argmax(filtered +
    G)``, G JAX's Gumbel draw of ``fold_in(rng, step)``, or ``noise(step,
    (B, V))`` when given. Returns (tokens [B, T], scores [B], lens [B]),
    T = max_gen_len + 1; tokens exclude the prefix and include EOS, and a
    row past its EOS holds ``pad_idx``."""
    state = sample_setup(step_fn, cache, prefix_tokens, vocab_size, max_gen_len, rng, pad_idx)
    run_chunks(state, lambda s: sample_step(s, step_fn, eos_idx, sampler, max_gen_len,
                                            min_gen_len, pad_idx, noise=noise),
               1 if noise is not None else CHUNK_STEPS)
    return sample_finish(state, eos_idx, sampler)
