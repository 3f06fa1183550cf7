"""Entry driver: embedding -> text through the public pipeline, beam search.

Set-up draws the tokenizer and the weights from the seed, builds the
configuration's ``EmbeddingToTextModelPipeline``, draws the pool of
embeddings, and warms the one decode shape the traffic uses (the beam
program of its batch, captured by ``TorchTextDecoder.warmup``) and then the
whole path for the traffic's ``warm_seconds`` (calls of ``predict``: in
most processes the card runs the search's loop ~9% slower for the first
3-55 s of decoding, PERF.md). The
window calls ``predict(chunk, target_lang, batch_size, beam_size,
max_gen_len)`` on chunk after chunk; ``decode_tokens_per_s`` is the tokens
of the returned best hypotheses, EOS included, over the window's whole time.

The benchmark records what the search hands back to the pipeline (a span
around the runtime's ``materialize_beam``: each batch's hypotheses, best
first, their scores and the device's steps) and, on a card, CUDA events
around each launch of the search's loop on the card (``LoopTimes``).
``correct``: after the window, the plain fp32 reference runs
teacher-forced over every hypothesis of a sample of the served rows (drawn
from the seed, the longest among them):

- ``score_gap``: the largest difference between the program's score of a
  hypothesis (its mean token log-probability, EOS included, as the search
  computed it through its cache) and the reference's score of the same
  tokens;
- ``pick_gap``: the search's selection. A beam extends a hypothesis only by
  a token among its row's best ``2 * beam_size``, so each served token's
  reference log-probability lies at most rounding below the reference's
  ``2 * beam_size``-th best at its position (the EOS that ``max_gen_len``
  forces is not a pick); the largest such gap;
- ``text_mismatch``: the sampled texts that differ from the reference's
  detokenisation of their best hypothesis.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
from perfbench.harness import bench, counters, devices, spans, traffic as gen, weights
from perfbench.harness import tokenizer as tokens
from perfbench.harness.window import chunked
from perfbench.reference import spm

class Beams:
    """The hypotheses of every row the search hands back (best first), and
    the steps the device ran for them (a span around ``materialize_beam``)."""

    def __init__(self, decoder: Any):
        self.decoder = decoder
        self.batches: List[Dict[str, Any]] = []
        self._steps = decoder.device_steps
        spans.wrap(decoder, "materialize_beam", "runtime.materialize_beam", self._record)

    def _record(self, args: tuple, kwargs: dict, out: Any) -> None:
        toks, scores, lens = out
        steps = self.decoder.device_steps
        self.batches.append({"tokens": np.array(toks), "scores": np.array(scores),
                             "lens": np.array(lens), "steps": steps - self._steps})
        self._steps = steps

    def mark(self) -> int:
        return len(self.batches)


class LoopTimes:
    """CUDA events around each launch of the search's loop on the card
    (``WhileGraph.launch``, at the stream boundary: the first event is
    queued behind the batch's setup, the second behind its last step), so
    each interval holds the loop's device time and nothing of the host's.
    The profiler sees none of the loop's kernels (PERF.md); in the traced
    unit these intervals stand for them, beside the profiler's other device
    operations (setup, tail, copies)."""

    def __init__(self, torch: Any):
        from sonar_tpu_torch.ops.cuda.graph_loop import WhileGraph

        self.torch, self.events, self.first = torch, [], 0
        self.origin = None
        inner = WhileGraph.launch

        def launch(graph: Any, stream: Any) -> None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            inner(graph, stream)
            b.record(stream)
            self.events.append((a, b))

        WhileGraph.launch = launch

    def start(self) -> int:
        """A call begins: its origin on the device; -> its first event."""
        self.first = len(self.events)
        self.origin = self.torch.cuda.Event(enable_timing=True)
        self.origin.record()
        return self.first

    def seconds(self, lo: int, hi: int) -> float:
        """The loops' device seconds of events lo..hi (once they are done)."""
        return sum(a.elapsed_time(b) for a, b in self.events[lo:hi]) * 1e-3

    def intervals(self, t0: float) -> List[tuple]:
        """The current call's loops on the host's clock (``t0``: the traced
        unit's synchronised start, where ``origin`` was recorded)."""
        return [("beam search loop (CUDA graph WHILE node; CUDA events)",
                 t0 + self.origin.elapsed_time(a) * 1e-3, t0 + self.origin.elapsed_time(b) * 1e-3)
                for a, b in self.events[self.first:]]


def run(cell: bench.Cell) -> bench.Outcome:
    import torch

    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig

    cfg, t, dev = cell.config, cell.traffic, cell.device
    system = bench.load_module(bench.PACKAGE / "systems" / f"{cfg['system']}.py")
    pieces = tokens.draw(cell.seed, cfg["model"]["vocab_info"]["size"])
    tokenizer = tokens.program_tokenizer(pieces)
    tree = weights.text_decoder(torch, cfg["model"], cell.seed,
                                getattr(torch, cfg["runtime"]["dtype"]), dev)
    pipe, decoder = system.build(torch, cfg, tree, tokenizer, dev)
    chunk = cell.scale.get("chunk", t["chunk"])
    n_chunks = cell.scale.get("pool_chunks", t["pool_chunks"])
    pool = gen.embeddings(chunk * n_chunks, cfg["model"]["model_dim"], t["scale"], cell.seed)
    lang, bsz = t["target_lang"], t["batch_size"]
    kw = {"beam_size": t["beam_size"], "max_gen_len": t["max_gen_len"]}
    prefix = tokenizer.create_encoder(lang=lang, mode="target").prefix_indices
    decoder.warmup(BeamSearchConfig.from_kwargs(decoder.max_target_len, **kw),
                   prefix_len=len(prefix), batch_sizes=(bsz,))
    loop = LoopTimes(torch) if dev.type == "cuda" else None

    def decode(lo: int) -> Dict[str, Any]:
        first = loop.start() if loop is not None else 0
        texts = pipe.predict(pool[lo:lo + chunk], target_lang=lang, batch_size=bsz, **kw)
        return {"first": lo, "texts": texts, "events": (first, len(loop.events) if loop else 0)}

    warm_from = time.perf_counter()
    warm_until = warm_from + cell.scale.get("warm_seconds", t["warm_seconds"])
    warm = []
    while True:  # the whole path, until the traffic's warm-up time has passed
        steps, t_a = decoder.device_steps, time.perf_counter()
        out = decode(0)
        warm.append((time.perf_counter() - t_a, decoder.device_steps - steps, out["events"]))
        if time.perf_counter() >= warm_until:
            break
    beams = Beams(decoder)
    devices.reset_peak(torch, dev)

    def call(i: int) -> Dict[str, Any]:
        return dict(decode((i % n_chunks) * chunk), marks=beams.mark())

    def count() -> Dict[str, float]:
        out = {"device_steps": decoder.device_steps}
        if dev.type == "cuda":
            out.update(counters.launches())
        return out

    win = chunked(torch, dev, cell.seconds, cell.trace, call, count,
                  extra=loop.intervals if loop is not None and cell.trace else None)
    setup_s = win.start - cell.t_start
    steady(loop, warm_from - cell.t_start, warm, [(u.seconds, u.counts["device_steps"], u.out["events"])
                        for u in win.units if not u.traced])
    peak = devices.peak(torch, dev)
    served = collect(win, beams, chunk)
    attempted = chunk * len(win.units)
    failed = attempted - len(served)
    n_tokens = sum(int(s["len"]) for s in served)
    observations = observe(cfg, t, win, beams)
    del pipe, decoder, tokenizer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare(cell, tree, pieces, pool, served, list(prefix))
    return bench.Outcome(attempted=attempted, failed=failed,
                         metrics={"decode_tokens_per_s": n_tokens / win.seconds},
                         setup_s=setup_s, checks=checks, memory_peak_bytes=peak,
                         observations=observations, trace=win.summary)


def steady(loop: Any, warm_from: float, warm: List[tuple], window: List[tuple]) -> None:
    """Standard error: each warm-up call's and untraced window call's ms a
    device step by the host's clock and, on a card, by the loop's events
    (the device alone), so that a slow stretch shows where it lies."""
    def line(calls: List[tuple]) -> str:
        return " ".join(f"{1e3 * sec / max(n, 1):.3f}" + (
            f"/{1e3 * loop.seconds(*ev) / max(n, 1):.3f}" if loop is not None else "")
            for sec, n, ev in calls)

    print(f"# ms a device step, a call (wall/loop): warm-up from {warm_from:.1f} s, "
          f"{len(warm)} calls: {line(warm)}; "
          f"window {len(window)}: {line(window)}", file=sys.stderr)


def collect(win, beams: Beams, chunk: int) -> List[Dict[str, Any]]:
    """Every served row: its embedding's index in the pool, its text, and
    the hypothesis the search handed back."""
    served, start = [], 0
    for u in win.units:
        recs = beams.batches[start:u.out["marks"]]
        start = u.out["marks"]
        rows = [(b, r) for b in recs for r in range(b["lens"].shape[0])]
        if len(rows) != len(u.out["texts"]) or len(rows) != chunk:
            continue  # a chunk that did not come back whole counts as failed
        for k, ((b, r), text) in enumerate(zip(rows, u.out["texts"])):
            served.append({"row": u.out["first"] + k, "text": text, "len": b["lens"][r, 0],
                           "hyps": [(b["tokens"][r, h][: b["lens"][r, h]], b["scores"][r, h])
                                    for h in range(b["lens"].shape[1])]})
    return served


def observe(cfg: dict, t: dict, win, beams: Beams) -> Dict[str, Any]:
    plain = win.untraced()
    bounds = [0] + [u.out["marks"] for u in win.units]
    steps = [beams.batches[b]["steps"] for u in plain
             for b in range(bounds[u.index], bounds[u.index + 1])]
    b_pad = 1 << (t["batch_size"] - 1).bit_length()
    return {"model": cfg["model"], "seconds": sum(u.seconds for u in plain),
            "counts": {k: sum(u.counts.get(k, 0) for u in plain) for k in win.units[0].counts},
            "decode_steps": steps, "rows": b_pad * t["beam_size"]}


def compare(cell: bench.Cell, tree: dict, pieces, pool: np.ndarray,
            served: List[Dict[str, Any]], prefix: List[int]) -> List[tuple]:
    import torch

    cfg, t = cell.config, cell.traffic
    ref = bench.reference(cfg)
    lim = cell.limits
    nan = float("nan")
    if not served:
        return [("score_gap", nan, lim.get("score_gap", nan))]
    n = min(cell.scale.get("sample", t["sample"]), len(served))
    longest = max(range(len(served)), key=lambda i: served[i]["len"])
    rest = [i for i in range(len(served)) if i != longest]
    picks = [longest] + [rest[i] for i in sorted(
        gen.rng_of(cell.seed, 7).choice(len(rest), min(n - 1, len(rest)), replace=False))]
    rows = [served[i] for i in picks]
    hyps = [(j, [int(x) for x in h], float(sc)) for j, r in enumerate(rows)
            for h, sc in r["hyps"]]
    memory = torch.as_tensor(pool[[rows[j]["row"] for j, _, _ in hyps]])
    seqs = [prefix + h[:-1] for _, h, _ in hyps]
    width, p = 2 * t["beam_size"], len(prefix)
    # the positions the search picked: every token but an EOS that max_gen_len forced
    chosen = [len(h) - (len(h) == t["max_gen_len"] + 1) for _, h, _ in hyps]
    tables = ref.log_probs(tree, cfg["model"], memory, seqs, quant=cfg["precision"])
    if cell.control:  # the reference in the lower precision in the program's place
        lower = ref.log_probs(tree, cfg["model"], memory, seqs,
                              quant=cfg["control"]["precision"])
    got, want, picked = [], [], []
    for (_, h, sc), m, lp in zip(hyps, chosen, tables):
        want.append(ref.hypothesis_score(lp, p, h))
        if cell.control:  # its score of the same tokens, and its own best ``width``
            lq = next(lower)
            got.append(ref.hypothesis_score(lq, p, h))
            picked.append(float(ref.kept_gaps(lp, lq, p, m, width).max()))
        else:
            got.append(sc)
            picked.append(float(ref.candidate_gaps(lp, p, h[:m], width).max()))
    gaps = [abs(g - w) for g, w in zip(got, want)]
    tok = spm.Tokenizer(pieces.pieces, pieces.scores, pieces.types, pieces.symbols)
    mismatch = sum(tok.decode([int(x) for x in r["hyps"][0][0]]) != r["text"] for r in rows)
    print(f"# score gaps over {len(gaps)} hypotheses: largest {max(gaps)!r}, root mean square "
          f"{float(np.sqrt(np.mean(np.square(gaps))))!r}; pick gaps: largest {max(picked)!r}, "
          f"hypotheses with one above 0: {sum(g > 0 for g in picked)}", file=sys.stderr)
    return [("score_gap", max(gaps), lim.get("score_gap", nan)),
            ("pick_gap", max(picked), lim.get("pick_gap", nan)),
            ("text_mismatch", float(mismatch), lim.get("text_mismatch", 0.0))]
