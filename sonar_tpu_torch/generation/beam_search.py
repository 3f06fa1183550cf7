"""Beam search for embedding-conditioned decoding (``sonar_tpu.generation.beam_search``).

The fairseq algorithm as the JAX package implements it:

- at each step the top ``2K`` candidates over (beam x vocab); EOS
  candidates ranked within the first ``K`` are finalized, the first ``K``
  non-EOS candidates continue;
- finalized score = cumulative logprob / length ** len_penalty when
  ``normalize_scores``;
- candidates are shortlisted per beam (``w0 = 2K + 2`` columns by the exact
  wide top-k, plus an exact unk column under an unk penalty), which provably
  holds the post-penalty top ``2K``;
- the search stops early once no live beam can beat the finished set (the
  bound switches to the shortest future length for a negative penalty);
- at the length limit the live beams finalize with EOS forced, the model's
  EOS logprob charged, and compete with the finished set.

The KV cache is never reordered: each row writes its own cache slot and the
search carries the ancestry table [B, K, S_cache] (the cache row that
produced each position of each beam), which ``step_fn`` reads through.

``beam_search_lax`` is the JAX ``lax.while_loop`` in three parts:
``beam_setup`` (the prefix steps and the state), ``beam_step`` (the body,
which reads nothing back to the host: the step counter, the penalties and
the exit test are device tensors, and every update is gated by the device
flag ``done``, JAX's ``cond``) and ``beam_finish`` (the tail). On a card
``TorchTextDecoder`` captures the body in a CUDA graph and loops it on the
device until ``done``; the eager loop, ``run_chunks``, runs the same body
and reads the flag once per chunk of steps (the CPU, a mesh of several
ranks). ``beam_search_oracle`` is the eager reference over a stateless
callback.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
from sonar_tpu_torch.ops.topk import exact_top_k_wide, top_k
import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 5
    min_gen_len: int = 1
    max_gen_len: int = 128
    len_penalty: float = 1.0
    normalize_scores: bool = True
    unk_penalty: float = 0.0
    # The JAX package's ``approx_topk=True`` shortlists with
    # ``lax.approx_max_k``, which is approximate only on a TPU: elsewhere it
    # lowers to an exact top-k. The port shortlists with the exact blocked
    # top-k (``ops/topk.exact_top_k_wide``) for both values, which is the
    # function JAX computes off a TPU.
    approx_topk: bool = False

    @classmethod
    def from_kwargs(cls, model_max_len: int, **kwargs: Any) -> "BeamSearchConfig":
        """Map reference generator kwargs (incl. ``max_seq_len``) to a
        config; unknown kwargs raise, as fairseq2's generator does.
        ``approx_topk`` is accepted and selects exactly (see the field)."""
        known = ("beam_size", "max_seq_len", "max_gen_len", "min_gen_len",
                 "len_penalty", "normalize_scores", "unk_penalty", "approx_topk")
        unknown = sorted(set(kwargs) - set(known))
        if unknown:
            raise TypeError(f"unsupported generator kwargs: {unknown}; supported: {list(known)}")
        cfg = cls()
        if "beam_size" in kwargs:
            cfg = dataclasses.replace(cfg, beam_size=int(kwargs["beam_size"]))
        max_seq_len = min(int(kwargs.get("max_seq_len", model_max_len)), model_max_len)
        max_gen = int(kwargs.get("max_gen_len", min(cfg.max_gen_len, max_seq_len)))
        cfg = dataclasses.replace(cfg, max_gen_len=min(max_gen, max_seq_len))
        for key in ("min_gen_len", "len_penalty", "normalize_scores", "unk_penalty",
                    "approx_topk"):
            if key in kwargs:
                cfg = dataclasses.replace(cfg, **{key: kwargs[key]})
        return cfg

    def normalized(self, score: float, length: int) -> float:
        if not self.normalize_scores:
            return score
        return score / (max(length, 1) ** self.len_penalty)


# ---------------------------------------------------------------------------
# Oracle: eager reference semantics over a stateless logprob callback
# ---------------------------------------------------------------------------


def beam_search_oracle(
    logprob_fn: Callable[[List[List[int]]], np.ndarray],
    prefix: List[int],
    eos_idx: int,
    config: BeamSearchConfig,
    unk_idx: Optional[int] = None,
    early_exit: bool = True,
) -> Tuple[List[int], float]:
    """Single-sequence beam search; ``logprob_fn(seqs)`` returns next-token
    logprobs [n, V] for full prefixes. Returns the best hypothesis
    (generated part incl. EOS) and its score. ``early_exit=False`` searches
    to ``max_gen_len`` (the referee for the bound)."""
    K = config.beam_size
    beams: List[Tuple[List[int], float]] = [(list(prefix), 0.0)]
    finished: List[Tuple[List[int], float]] = []

    exhausted = True
    for step in range(config.max_gen_len):
        lp = np.asarray(logprob_fn([b[0] for b in beams]), np.float64)
        if step + 1 < config.min_gen_len:
            lp[:, eos_idx] = -np.inf
        if unk_idx is not None and config.unk_penalty:
            lp[:, unk_idx] -= config.unk_penalty
        cands = []
        for bi, (_, sc) in enumerate(beams):
            for v in np.argsort(lp[bi])[::-1][: 2 * K]:
                cands.append((sc + lp[bi, v], bi, int(v)))
        cands.sort(key=lambda x: -x[0])
        cands = cands[: 2 * K]
        new_beams = []
        for rank, (sc, bi, v) in enumerate(cands):
            if v == eos_idx and rank < K:
                finished.append((beams[bi][0][len(prefix):] + [v],
                                 config.normalized(sc, step + 1)))
            elif v != eos_idx and len(new_beams) < K:
                new_beams.append((beams[bi][0] + [v], sc))
        beams = new_beams
        # Upper bound of a live beam's final score: the longest finalization
        # (max_gen_len + 1, forced EOS) for len_penalty >= 0, the next step's
        # for a negative penalty.
        bound_len = (config.max_gen_len + 1
                     if (not config.normalize_scores or config.len_penalty >= 0) else step + 2)
        if not beams or (
            early_exit
            and len(finished) >= K
            and max(config.normalized(sc, bound_len) for _, sc in beams)
            <= min(f[1] for f in sorted(finished, key=lambda x: -x[1])[:K])
        ):
            exhausted = False
            break

    if exhausted and beams:
        # The length limit forces EOS, charged with the model's logprob.
        lp = np.asarray(logprob_fn([b[0] for b in beams]), np.float64)
        for bi, (toks, sc) in enumerate(beams):
            finished.append((toks[len(prefix):] + [eos_idx],
                             config.normalized(sc + lp[bi, eos_idx], config.max_gen_len + 1)))
    finished.sort(key=lambda x: -x[1])
    return finished[0]


# ---------------------------------------------------------------------------
# Batched search over a stepping decoder with a never-reordered KV cache
# ---------------------------------------------------------------------------


# Body steps of the eager loop between two host reads of the exit flag: a
# search that ends inside a chunk runs up to CHUNK_STEPS - 1 gated steps.
CHUNK_STEPS = 4


@dataclass
class BeamState:
    """The search's carry on the device (JAX's ``BeamState``, with the last
    logits, the penalties and the exit flag), updated in place by
    ``beam_step``: its tensors can be the static buffers of a CUDA graph.

    ``len_penalty`` / ``unk_penalty`` (fp32) and ``min_gen_len`` (int32) are
    0-d tensors, as JAX passes them traced, so that one captured program
    serves every value; ``done`` is JAX's ``cond`` negated for the state as
    it stands: no further step can change any output."""

    tokens: torch.Tensor       # [B, K, T] live beams' generated tokens
    scores: torch.Tensor       # [B, K] cumulative logprob
    fin_tokens: torch.Tensor   # [B, K, T]
    fin_scores: torch.Tensor   # [B, K] normalized
    fin_lens: torch.Tensor     # [B, K] generated length incl. EOS
    anc: torch.Tensor          # [B, K, S_cache] int32 cache row per position
    logits: torch.Tensor       # [B * K, V] fp32 raw logits of the next token
    step: torch.Tensor         # 0-d int32: search steps taken
    done: torch.Tensor         # 0-d bool
    len_penalty: torch.Tensor
    unk_penalty: torch.Tensor
    min_gen_len: torch.Tensor
    prefix_len: int
    cache: Any


def beam_knobs(config: BeamSearchConfig, device: Any) -> Tuple[torch.Tensor, ...]:
    """(len_penalty, unk_penalty, min_gen_len) of ``config`` as 0-d tensors on
    ``device`` (filled on the device: no host-to-device copy)."""
    return (torch.full((), float(config.len_penalty), dtype=torch.float32, device=device),
            torch.full((), float(config.unk_penalty), dtype=torch.float32, device=device),
            torch.full((), int(config.min_gen_len), dtype=torch.int32, device=device))


def _length_norm(scores: torch.Tensor, length: torch.Tensor, config: BeamSearchConfig,
                 penalty: torch.Tensor) -> torch.Tensor:
    """scores / max(length, 1) ** penalty, ``length`` a device tensor."""
    if not config.normalize_scores:
        return scores
    return scores / torch.clamp(length.float(), min=1.0) ** penalty


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis`` on dim 1 for [B, n, ...] with idx [B, m]."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


def _can_improve(state: BeamState, config: BeamSearchConfig) -> torch.Tensor:
    """JAX's ``cond`` on the device: a step is left and some row's live
    beams can still beat its finished set. The upper bound of a live beam's
    final score (see the oracle) is its score normalized at the longest
    finalization, or at the next step's for a negative penalty."""
    bound_len = torch.where(state.len_penalty >= 0, config.max_gen_len + 1, state.step + 1)
    live_best = _length_norm(state.scores, bound_len, config, state.len_penalty).amax(dim=1)
    improvable = (live_best > state.fin_scores.amin(dim=1)).any()
    return (state.step < config.max_gen_len) & improvable


def beam_setup(
    step_fn: Callable,
    cache: Any,
    prefix_tokens: torch.Tensor,
    eos_idx: int,
    vocab_size: int,
    config: BeamSearchConfig,
    pad_idx: int = 0,
    cache_len: Optional[int] = None,
    knobs: Optional[Tuple[torch.Tensor, ...]] = None,
) -> BeamState:
    """Force the prefix through the decoder and build the search's state.
    ``knobs``: ``beam_knobs(config)``, or tensors the caller fills."""
    dev = prefix_tokens.device
    B, P = prefix_tokens.shape
    K = config.beam_size
    T = config.max_gen_len + 1
    N = B * K
    S_cache = cache_len if cache_len is not None else P + config.max_gen_len + 1
    beam_ids = torch.arange(K, device=dev)

    # Identity ancestry: every row's prefix positions live in its own slot.
    anc = beam_ids[None, :, None].expand(B, K, S_cache).to(torch.int32).contiguous()
    logits = torch.zeros((N, vocab_size), dtype=torch.float32, device=dev)
    for i in range(P):
        toks = prefix_tokens[:, i].long()[:, None].expand(B, K).reshape(N)
        logits, cache = step_fn(toks, cache, anc.reshape(N, S_cache))
    len_penalty, unk_penalty, min_gen_len = knobs if knobs is not None else beam_knobs(config, dev)
    state = BeamState(
        tokens=torch.full((B, K, T), pad_idx, dtype=torch.long, device=dev),
        # Step 0: only beam 0 is live (all beams start identical).
        scores=torch.where(beam_ids == 0, 0.0, NEG_INF).float()[None, :].repeat(B, 1),
        fin_tokens=torch.full((B, K, T), pad_idx, dtype=torch.long, device=dev),
        fin_scores=torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev),
        fin_lens=torch.zeros((B, K), dtype=torch.long, device=dev),
        anc=anc, logits=logits,
        step=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        len_penalty=len_penalty, unk_penalty=unk_penalty, min_gen_len=min_gen_len,
        prefix_len=P, cache=cache,
    )
    state.done = ~_can_improve(state, config)
    return state


def _commit(go: torch.Tensor, pairs: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]) -> None:
    """dst <- new where ``go`` (a 0-d device bool), in place."""
    for dst, new in pairs:
        torch.where(go, new, dst, out=dst)


def beam_step(
    state: BeamState,
    step_fn: Callable,
    eos_idx: int,
    vocab_size: int,
    config: BeamSearchConfig,
    unk_idx: Optional[int] = None,
) -> None:
    """One iteration of JAX's ``while_loop`` body, in place, reading nothing
    back to the host. Every update is gated by ``~state.done``: a step
    taken once the state is done still runs the decoder but leaves every
    output as it was, and the state stays done. ``unk_idx`` turns the unk
    penalty's column on (for a nonzero ``config.unk_penalty``; its value is
    ``state.unk_penalty``)."""
    go = ~state.done
    B, K, T = state.tokens.shape
    N, S_cache = B * K, state.anc.shape[-1]
    dev = state.tokens.device
    step, logits = state.step, state.logits
    beam_ids = torch.arange(K, device=dev)

    lse = torch.logsumexp(logits, dim=-1).reshape(B, K)
    w0 = min(2 * K + 2, vocab_size)
    if w0 == vocab_size:
        row_s = logits
        row_i = torch.arange(vocab_size, device=dev).expand(N, vocab_size)
    else:
        row_s, row_i = exact_top_k_wide(logits, w0)
    lp_sel = row_s.reshape(B, K, w0) - lse[:, :, None]
    tok_sel = row_i.reshape(B, K, w0)
    lp_sel = torch.where((step + 1 < state.min_gen_len) & (tok_sel == eos_idx), NEG_INF, lp_sel)
    if unk_idx is not None and config.unk_penalty:
        lp_sel = lp_sel - state.unk_penalty * (tok_sel == unk_idx)
        unk_lp = logits.reshape(B, K, vocab_size)[:, :, unk_idx] - lse - state.unk_penalty
        present = (tok_sel == unk_idx).any(dim=-1)
        lp_sel = torch.cat([lp_sel, torch.where(present, NEG_INF, unk_lp)[:, :, None]], -1)
        tok_sel = torch.cat([tok_sel, torch.full((B, K, 1), unk_idx, dtype=tok_sel.dtype,
                                                 device=dev)], dim=-1)
    w = lp_sel.shape[-1]
    cand = state.scores[:, :, None] + lp_sel                             # [B, K, w]
    flat_i = (beam_ids[None, :, None] * vocab_size + tok_sel).reshape(B, K * w)
    top_scores, pos = top_k(cand.reshape(B, K * w), 2 * K)
    top_idx = torch.gather(flat_i, 1, pos)
    top_beam, top_tok = top_idx // vocab_size, top_idx % vocab_size
    is_eos = top_tok == eos_idx
    positions_t = torch.arange(T, device=dev)
    length = step + 1

    # finalize: EOS candidates ranked within the first K
    rank = torch.arange(2 * K, device=dev)[None, :]
    finalize = is_eos & (rank < K) & (top_scores > NEG_INF / 2)
    cand_fin = torch.where(finalize, _length_norm(top_scores, length, config, state.len_penalty),
                           NEG_INF)
    cand_tokens = torch.where(positions_t == step, eos_idx, _take(state.tokens, top_beam))
    all_scores = torch.cat([state.fin_scores, cand_fin], dim=1)
    all_tokens = torch.cat([state.fin_tokens, cand_tokens], dim=1)
    all_lens = torch.cat([state.fin_lens, length.long().expand_as(top_beam)], dim=1)
    fin_scores, fin_idx = top_k(all_scores, K)
    fin_tokens, fin_lens = _take(all_tokens, fin_idx), _take(all_lens, fin_idx)

    # continue: the first K non-EOS candidates
    cont = torch.where(is_eos, NEG_INF, top_scores)
    order = torch.sort(cont, dim=1, descending=True, stable=True).indices[:, :K]
    scores = torch.gather(cont, 1, order)
    sel_beam = torch.gather(top_beam, 1, order)
    sel_tok = torch.gather(top_tok, 1, order)
    tokens = torch.where(positions_t == step, sel_tok[:, :, None], _take(state.tokens, sel_beam))

    # Follow the winners through the ancestry; the K/V the next step writes
    # (at P + step) lands in each row's own slot.
    positions_s = torch.arange(S_cache, device=dev)
    anc = torch.where(positions_s == state.prefix_len + step,
                      beam_ids[None, :, None].to(torch.int32), _take(state.anc, sel_beam))
    anc = anc.contiguous()
    logits, state.cache = step_fn(sel_tok.reshape(N), state.cache, anc.reshape(N, S_cache))
    _commit(go, ((state.tokens, tokens), (state.scores, scores), (state.fin_tokens, fin_tokens),
                 (state.fin_scores, fin_scores), (state.fin_lens, fin_lens), (state.anc, anc),
                 (state.logits, logits)))
    state.step.add_(go.to(torch.int32))
    state.done.copy_(~_can_improve(state, config))


def beam_finish(state: BeamState, eos_idx: int,
                config: BeamSearchConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The outputs: at the length limit the live beams finalize with EOS
    forced and its logprob charged; after an early exit they cannot improve
    and are out. -> (tokens [B, K, T] int32, scores [B, K], lens [B, K]
    int32) sorted by score."""
    B, K, T = state.tokens.shape
    exhausted = state.step >= config.max_gen_len
    length = state.step + 1
    eos_lp = (state.logits[:, eos_idx] - torch.logsumexp(state.logits, dim=-1)).reshape(B, K)
    live_scores = torch.where(
        exhausted, _length_norm(state.scores + eos_lp, length, config, state.len_penalty), NEG_INF)
    positions_t = torch.arange(T, device=state.tokens.device)
    live_tokens = torch.where(positions_t == torch.clamp(state.step, max=T - 1), eos_idx,
                              state.tokens)
    all_scores = torch.cat([state.fin_scores, live_scores], dim=1)
    all_tokens = torch.cat([state.fin_tokens, live_tokens], dim=1)
    all_lens = torch.cat([state.fin_lens, length.long().expand_as(state.fin_lens)], dim=1)
    out_scores, order = top_k(all_scores, K)
    return (_take(all_tokens, order).to(torch.int32), out_scores,
            _take(all_lens, order).to(torch.int32))


def run_chunks(state: BeamState, step: Callable[[BeamState], None], chunk: int = CHUNK_STEPS,
               agree: Optional[Callable[[bool], bool]] = None) -> int:
    """The eager loop: step until the state is done, in chunks of ``chunk``
    steps with one host read of the device flag after each; returns the
    steps run, gated ones included (up to ``chunk - 1`` run once the state
    is done, and change nothing). ``step(state)`` is one ``beam_step``.

    ``agree(live)`` (under a mesh of several ranks, whose every decoder
    layer holds a collective) is asked once a chunk whether some rank's
    state is not done: every rank goes on while one is, its own steps gated
    once it is done, so all take the same number of steps."""
    ran = 0
    while True:
        for _ in range(chunk):
            step(state)
        ran += chunk
        live = not bool(state.done)
        if not (agree(live) if agree is not None else live):
            return ran


def beam_search_lax(
    step_fn: Callable,
    cache: Any,
    prefix_tokens: torch.Tensor,
    eos_idx: int,
    vocab_size: int,
    config: BeamSearchConfig,
    pad_idx: int = 0,
    unk_idx: Optional[int] = None,
    cache_len: Optional[int] = None,
    agree: Optional[Callable[[bool], bool]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beam search: ``beam_setup``, ``run_chunks``, ``beam_finish``.

    step_fn(tokens [N], cache, ancestry [N, S_cache]) -> (raw fp32 logits
    [N, V], cache): one decoder step for the N = B*K beam rows, reading past
    K/V through the ancestry table. ``cache`` holds B*K rows at step 0.
    prefix_tokens: [B, P] forced prompt. cache_len: the KV buffer length,
    P + max_gen_len + 1 by default. ``agree``: see ``run_chunks``.

    Returns (tokens [B, K, T] int32, scores [B, K] fp32, lengths [B, K]
    int32) sorted by score; tokens exclude the prefix and include EOS.
    """
    state = beam_setup(step_fn, cache, prefix_tokens, eos_idx, vocab_size, config, pad_idx,
                       cache_len)
    run_chunks(state, lambda st: beam_step(st, step_fn, eos_idx, vocab_size, config, unk_idx),
               agree=agree)
    return beam_finish(state, eos_idx, config)
