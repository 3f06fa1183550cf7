"""Sampling generation, top-p and top-k (``sonar_tpu.generation.sampling``).

One hypothesis per input, generated against the same preallocated KV cache
as beam search, in the plain decode mode. ``sample_lax`` is the JAX
``lax.while_loop`` as a Python loop over tensors: its exit test reads one
boolean from the device per step.

Random numbers: ``jax.random.categorical`` draws ``argmax(logits +
gumbel(key, logits.shape))``, with the key ``fold_in(PRNGKey(seed), step)``
at each step. The port draws its Gumbel noise from an explicit
``torch.Generator`` on the model's device, one [B, V] draw per step, so the
same seed gives other numbers than JAX's. A ``noise(step, shape)`` callable
given to the loop replaces the generator: the tests feed JAX's own draws
through it, so both packages sample the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

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


def gumbel(generator: torch.Generator, shape: Tuple[int, ...], device: Any) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in (0, 1), fp32."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _tempered(logprobs: torch.Tensor, temperature: float) -> torch.Tensor:
    if temperature == 1.0:
        return logprobs
    return torch.log_softmax(logprobs / temperature, dim=-1)


def sample_lax(
    step_fn: Callable,
    cache: Any,
    prefix_tokens: torch.Tensor,
    eos_idx: int,
    vocab_size: int,
    sampler: Any,
    generator: Optional[torch.Generator],
    max_gen_len: int,
    min_gen_len: int = 1,
    pad_idx: int = 0,
    noise: Optional[Callable[[int, Tuple[int, ...]], Any]] = None,
    agree: Callable[[bool], bool] = bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched ancestral sampling.

    step_fn(tokens [B], cache) -> (fp32 log-probabilities [B, V], cache).
    prefix_tokens: [B, P] forced prompt. Each step samples ``argmax(filtered
    + G)`` with G a [B, V] Gumbel draw: ``noise(step, (B, V))`` when given,
    else from ``generator``. Returns (tokens [B, T], scores [B], lens [B]),
    T = max_gen_len + 1; tokens exclude the prefix and include EOS, and a
    row past its EOS holds ``pad_idx``. ``agree`` turns "a row is still
    open" into the decision to step again (under a mesh, across every rank).
    """
    dev = prefix_tokens.device
    B, P = prefix_tokens.shape
    T = max_gen_len + 1
    temp = getattr(sampler, "temperature", 1.0)

    logprobs = torch.zeros((B, vocab_size), dtype=torch.float32, device=dev)
    for i in range(P):
        logprobs, cache = step_fn(prefix_tokens[:, i], cache)

    tokens = torch.full((B, T), pad_idx, dtype=torch.long, device=dev)
    scores = torch.zeros((B,), dtype=torch.float32, device=dev)
    lens = torch.zeros((B,), dtype=torch.long, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)

    step = 0
    while step < max_gen_len and agree(not bool(finished.all())):
        lp = _tempered(logprobs, temp)
        if step + 1 < min_gen_len:
            lp = lp.clone()
            lp[:, eos_idx] = NEG_INF
        filtered = sampler.filter_logprobs(lp)
        g = (noise(step, tuple(filtered.shape)) if noise is not None
             else gumbel(generator, tuple(filtered.shape), dev))
        tok = torch.argmax(filtered + torch.as_tensor(g, dtype=torch.float32, device=dev), dim=-1)
        tok = torch.where(finished, pad_idx, tok)
        chosen = torch.gather(lp, 1, tok[:, None])[:, 0]
        scores = torch.where(finished, scores, scores + chosen)
        tokens[:, step] = torch.where(finished, tokens[:, step], tok)
        lens = torch.where(finished, lens, step + 1)
        finished = finished | (tok == eos_idx)
        logprobs, cache = step_fn(tok, cache)
        step += 1

    # Force-close unfinished rows with EOS, charging the model's EOS logprob
    # of the last step on the same temperature scale as every score term.
    final = _tempered(logprobs, temp)
    unfinished = ~finished
    positions = torch.arange(T, device=dev)
    tokens = torch.where((positions[None, :] == min(step, T - 1)) & unfinished[:, None],
                         eos_idx, tokens)
    scores = torch.where(unfinished, scores + final[:, eos_idx], scores)
    lens = torch.where(unfinished, step + 1, lens)
    return tokens.to(torch.int32), scores, lens.to(torch.int32)
