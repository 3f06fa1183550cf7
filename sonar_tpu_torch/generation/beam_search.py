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

``beam_search_lax`` is the JAX ``lax.while_loop`` as a Python loop over
tensors: its exit test reads one boolean from the device per step.
``beam_search_oracle`` is the eager reference over a stateless callback.
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


def _length_norm(scores: torch.Tensor, length: int, config: BeamSearchConfig) -> torch.Tensor:
    if not config.normalize_scores:
        return scores
    denom = torch.tensor(float(max(length, 1)), dtype=torch.float32) ** config.len_penalty
    return scores / denom.to(scores.device)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis`` on dim 1 for [B, n, ...] with idx [B, m]."""
    idx = idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(*idx.shape, *x.shape[2:])
    return torch.gather(x, 1, idx)


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
    agree: Callable[[bool], bool] = bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched beam search.

    step_fn(tokens [N], cache, ancestry [N, S_cache]) -> (raw fp32 logits
    [N, V], cache): one decoder step for the N = B*K beam rows, reading past
    K/V through the ancestry table. ``cache`` holds B*K rows at step 0.
    prefix_tokens: [B, P] forced prompt. cache_len: the KV buffer length,
    P + max_gen_len + 1 by default.

    Returns (tokens [B, K, T] int32, scores [B, K] fp32, lengths [B, K]
    int32) sorted by score; tokens exclude the prefix and include EOS.

    ``agree`` turns this batch's "some row can still improve" into the
    decision to take another step; under a mesh it agrees across every rank
    (each decoder layer holds a collective, so all ranks step together).
    """
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
        toks = prefix_tokens[:, i].long().repeat_interleave(K)
        logits, cache = step_fn(toks, cache, anc.reshape(N, S_cache))

    tokens = torch.full((B, K, T), pad_idx, dtype=torch.long, device=dev)
    # Step 0: only beam 0 is live (all beams start identical).
    scores = torch.where(beam_ids == 0, 0.0, NEG_INF).float()[None, :].repeat(B, 1)
    fin_tokens = torch.full((B, K, T), pad_idx, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    fin_lens = torch.zeros((B, K), dtype=torch.long, device=dev)
    positions_t = torch.arange(T, device=dev)
    positions_s = torch.arange(S_cache, device=dev)
    w0 = min(2 * K + 2, vocab_size)
    use_unk = unk_idx is not None and bool(config.unk_penalty)

    step = 0
    while step < config.max_gen_len:
        # Upper bound of any live beam's final score (see the oracle).
        bound_len = config.max_gen_len + 1 if config.len_penalty >= 0 else step + 1
        live_best = _length_norm(scores, bound_len, config).amax(dim=1)
        if not agree(bool((live_best > fin_scores.amin(dim=1)).any())):
            break

        lse = torch.logsumexp(logits, dim=-1).reshape(B, K)
        if w0 == vocab_size:
            row_s = logits
            row_i = torch.arange(vocab_size, device=dev).expand(N, vocab_size)
        else:
            row_s, row_i = exact_top_k_wide(logits, w0)
        lp_sel = row_s.reshape(B, K, w0) - lse[:, :, None]
        tok_sel = row_i.reshape(B, K, w0)
        if step + 1 < config.min_gen_len:
            lp_sel = torch.where(tok_sel == eos_idx, NEG_INF, lp_sel)
        if use_unk:
            lp_sel = lp_sel - config.unk_penalty * (tok_sel == unk_idx)
            unk_lp = logits.reshape(B, K, vocab_size)[:, :, unk_idx] - lse - config.unk_penalty
            present = (tok_sel == unk_idx).any(dim=-1)
            lp_sel = torch.cat([lp_sel, torch.where(present, NEG_INF, unk_lp)[:, :, None]], -1)
            tok_sel = torch.cat([tok_sel, torch.full((B, K, 1), unk_idx, dtype=tok_sel.dtype,
                                                     device=dev)], dim=-1)
        w = lp_sel.shape[-1]
        cand = scores[:, :, None] + lp_sel                                   # [B, K, w]
        flat_i = (beam_ids[None, :, None] * vocab_size + tok_sel).reshape(B, K * w)
        top_scores, pos = top_k(cand.reshape(B, K * w), 2 * K)
        top_idx = torch.gather(flat_i, 1, pos)
        top_beam, top_tok = top_idx // vocab_size, top_idx % vocab_size
        is_eos = top_tok == eos_idx

        # finalize: EOS candidates ranked within the first K
        rank = torch.arange(2 * K, device=dev)[None, :]
        finalize = is_eos & (rank < K) & (top_scores > NEG_INF / 2)
        cand_fin = torch.where(finalize, _length_norm(top_scores, step + 1, config), NEG_INF)
        cand_tokens = torch.where(positions_t == step, eos_idx, _take(tokens, top_beam))
        all_scores = torch.cat([fin_scores, cand_fin], dim=1)
        all_tokens = torch.cat([fin_tokens, cand_tokens], dim=1)
        all_lens = torch.cat([fin_lens, torch.full_like(top_beam, step + 1)], dim=1)
        fin_scores, fin_idx = top_k(all_scores, K)
        fin_tokens, fin_lens = _take(all_tokens, fin_idx), _take(all_lens, fin_idx)

        # continue: the first K non-EOS candidates
        cont = torch.where(is_eos, NEG_INF, top_scores)
        order = torch.sort(cont, dim=1, descending=True, stable=True).indices[:, :K]
        scores = torch.gather(cont, 1, order)
        sel_beam = torch.gather(top_beam, 1, order)
        sel_tok = torch.gather(top_tok, 1, order)
        tokens = torch.where(positions_t == step, sel_tok[:, :, None], _take(tokens, sel_beam))

        # Follow the winners through the ancestry; the K/V the next step
        # writes (at P + step) lands in each row's own slot.
        anc = torch.where(positions_s == P + step, beam_ids[None, :, None].to(torch.int32),
                          _take(anc, sel_beam)).contiguous()
        logits, cache = step_fn(sel_tok.reshape(N), cache, anc.reshape(N, S_cache))
        step += 1

    # At the length limit the live beams finalize with EOS forced and its
    # logprob charged; after an early exit they cannot improve and are out.
    exhausted = step >= config.max_gen_len
    eos_lp = (logits[:, eos_idx] - torch.logsumexp(logits, dim=-1)).reshape(B, K)
    live_scores = (_length_norm(scores + eos_lp, step + 1, config) if exhausted
                   else torch.full_like(scores, NEG_INF))
    live_tokens = torch.where(positions_t == min(step, T - 1), eos_idx, tokens)
    all_scores = torch.cat([fin_scores, live_scores], dim=1)
    all_tokens = torch.cat([fin_tokens, live_tokens], dim=1)
    all_lens = torch.cat([fin_lens, torch.full_like(fin_lens, step + 1)], dim=1)
    out_scores, order = top_k(all_scores, K)
    return (_take(all_tokens, order).to(torch.int32), out_scores,
            _take(all_lens, order).to(torch.int32))
