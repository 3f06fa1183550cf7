"""Entry driver: text -> text through the public translation pipeline of an
encoder-decoder model (NLLB-200 MoE), beam search.

Set-up draws the tokenizer from the seed and the weights from the
configuration's ``weights_seed`` (one model for every run, as a deployment
serves one; its routers fitted to their inputs, ``weights_nllb_moe``), builds the
configuration's ``TextToTextModelPipeline`` over the model's
``TorchEncoderDecoder``, makes the traffic's pool of raw sentences
(``text_embed.short``'s corpus: every seed the same lengths, reordered),
captures the one beam program the traffic uses (``warmup`` at the
traffic's batch and the first memory bucket: the memory of every source
of up to 128 tokens is loaded into it), then runs the whole path for the traffic's
``warm_seconds`` (calls of ``predict``; the loop's slow first stretch,
PERF.md). The window calls ``predict(chunk, source_lang, target_lang,
batch_size, beam_size, max_gen_len)`` on chunk after chunk;
``decode_tokens_per_s`` is the tokens of the returned best hypotheses, EOS
included, over the window's whole time.

The benchmark records what the search hands back (a span around the
runtime's ``materialize_beam``, ``predict_decode.Beams``), the source ids
and true lengths of every encoded batch (a span around ``encode_batch``:
the pipeline may batch a chunk in another order than the chunk's, and a
row's source ids name its sentence), CUDA events around
each launch of the search's loop (``predict_decode.LoopTimes``) and, in the
traced unit, around each call of the program's expert FFNs made outside a
capture (``ExpertTimes``: the encoder's sparse layers) with their group
sizes. The program's own counters are read once a call: the decoder's
device steps and the expert counters (``NllbMoeModel.read_counters``: rows
each held expert received, calls in which it received any).

At a test's scale (``cell.scale`` with a model, on the CPU) the model, its
precision and the traffic are cut further (``TEST_MODEL``, ``TEST_RUNTIME``,
``TEST_TRAFFIC``) so that a run takes seconds; a measured run never is.

``correct``: after the window, the plain fp32 reference encodes the source
of each of a sample of the served rows again (its own tokenisation; drawn
from the seed, the longest hypothesis's row first) and runs the decoder
teacher-forced over every hypothesis of those rows; ``score_gap``,
``pick_gap`` and ``text_mismatch`` as ``predict_decode``'s. (The share of
routing decisions that bf16 flips: ``scripts/nllb_moe_flips.py``.)
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
from perfbench.drivers.predict_decode import Beams, LoopTimes, steady
from perfbench.harness import bench, devices, spans, traffic as gen, weights_nllb_moe
from perfbench.harness import tokenizer as tokens
from perfbench.harness.window import TRACED_UNIT, chunked
from perfbench.reference import spm

# At a test's scale every layer is sparse and holds all 8 experts, so that the
# expert layers carry enough of the output for a planted fault to show, and
# the program computes in fp32, so that a sound run reads near 0.
TEST_MODEL = {"num_decoder_layers": 2, "encoder_sparse_step": 1, "decoder_sparse_step": 1,
              "router_experts": 8, "num_experts": 8, "max_seq_len": 128}
TEST_RUNTIME = {"dtype": "float32"}
TEST_TRAFFIC = {"batch_size": 8, "max_gen_len": 6, "chunk": 32, "sample": 6}
PLACEHOLDER = "lng000_Latn"  # the synthetic tokenizer's code renamed to the target's


class ExpertTimes:
    """CUDA events around each call of the program's expert FFNs
    (``sonar_tpu_torch.nn.moe.experts``) made while ``on`` and outside a
    stream capture, with a device copy of the call's group ends."""

    def __init__(self, torch: Any):
        from sonar_tpu_torch.nn import moe

        self.on, self.calls = False, []
        inner = moe.experts

        def experts(params: Any, rows: Any, slots: Any, offs: Any) -> Any:
            if not self.on or torch.cuda.is_current_stream_capturing():
                return inner(params, rows, slots, offs)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            y = inner(params, rows, slots, offs)
            b.record()
            self.calls.append((a, b, offs.clone()))
            return y

        moe.experts = experts

    def read(self) -> List[tuple]:
        """(device seconds, rows of each held expert) of every timed call."""
        out = []
        for a, b, offs in self.calls:
            ends = offs.cpu().numpy().astype(np.int64)
            out.append((a.elapsed_time(b) * 1e-3, np.diff(ends, prepend=0).tolist()))
        return out


def run(cell: bench.Cell) -> bench.Outcome:
    import torch

    from sonar_tpu_torch.generation.beam_search import BeamSearchConfig
    from sonar_tpu_torch.generation.decoder_runtime import MEMORY_BUCKETS

    cfg, t, dev = cell.config, dict(cell.traffic), cell.device
    if "model" in cell.scale:
        cfg = dict(cfg, model=dict(cfg["model"], **TEST_MODEL),
                   runtime=dict(cfg["runtime"], **TEST_RUNTIME))
        t.update(TEST_TRAFFIC)
    system = bench.load_module(bench.PACKAGE / "systems" / f"{cfg['system']}.py")
    src_lang, tgt_lang = t["source_lang"], t["target_lang"]
    pieces = tokens.draw(cell.seed, cfg["model"]["vocab_info"]["size"])
    if tgt_lang not in pieces.symbols:
        pieces.symbols[pieces.symbols.index(PLACEHOLDER)] = tgt_lang
    tokenizer = tokens.program_tokenizer(pieces)
    tree = weights_nllb_moe.nllb_moe(torch, cfg["model"], cfg["weights_seed"],
                                     getattr(torch, cfg["runtime"]["dtype"]), dev)
    pipe, runtime = system.build(torch, cfg, tree, tokenizer, dev)
    chunk = min(cell.scale.get("chunk", t["chunk"]), t["chunk"])
    n_chunks = cell.scale.get("pool_chunks", t["pool_chunks"])
    pool = gen.text_pool(pieces.words, t["lengths"], chunk, n_chunks, cell.seed)
    bsz = t["batch_size"]
    kw = {"beam_size": t["beam_size"], "max_gen_len": t["max_gen_len"]}
    prefix = tokenizer.create_encoder(lang=tgt_lang, mode="target").prefix_indices
    runtime.warmup(BeamSearchConfig.from_kwargs(runtime.max_target_len, **kw),
                   prefix_len=len(prefix), batch_sizes=(bsz,), memory_len=MEMORY_BUCKETS[0])
    cuda = dev.type == "cuda"
    loop = LoopTimes(torch) if cuda else None
    experts = ExpertTimes(torch) if cuda else None

    def translate(i: int) -> Dict[str, Any]:
        first = loop.start() if loop is not None else 0
        lo = (i % n_chunks) * chunk
        texts = pipe.predict(pool[i % n_chunks], source_lang=src_lang, target_lang=tgt_lang,
                             batch_size=bsz, **kw)
        return {"first": lo, "texts": texts, "events": (first, len(loop.events) if loop else 0)}

    warm_from = time.perf_counter()
    warm_until = warm_from + cell.scale.get("warm_seconds", t["warm_seconds"])
    warm = []
    while True:
        steps, t_a = runtime.device_steps, time.perf_counter()
        out = translate(0)
        warm.append((time.perf_counter() - t_a, runtime.device_steps - steps, out["events"]))
        if time.perf_counter() >= warm_until:
            break
    beams = Beams(runtime)
    encoded: List[np.ndarray] = []
    sources: List[np.ndarray] = []

    def record(args: tuple, kwargs: dict, out: Any) -> None:
        batch = args[0] if args else kwargs["batch"]
        n = len(out.lens)
        encoded.append(np.asarray(batch.seq_lens)[:n].copy())
        sources.append(np.asarray(batch.seqs)[:n].copy())

    spans.wrap(runtime, "encode_batch", "runtime.encode_batch", record)
    devices.reset_peak(torch, dev)

    def call(i: int) -> Dict[str, Any]:
        if experts is not None:
            experts.on = cell.trace and i == TRACED_UNIT
        out = dict(translate(i), marks=beams.mark(), encoded=len(encoded))
        if experts is not None:
            experts.on = False
        return out

    def count() -> Dict[str, float]:
        c = runtime.model.read_counters()  # one copy from the device a call
        enc = list(runtime.model.sparse_rows("encoder"))
        dec = list(runtime.model.sparse_rows("decoder"))
        return {"device_steps": runtime.device_steps,
                "expert_rows.encoder": int(c["rows"][enc].sum()),
                "expert_rows.decoder": int(c["rows"][dec].sum()),
                "expert_hits.encoder": int(c["hits"][enc].sum()),
                "expert_hits.decoder": int(c["hits"][dec].sum())}

    win = chunked(torch, dev, cell.seconds, cell.trace, call, count,
                  extra=loop.intervals if loop is not None and cell.trace else None)
    setup_s = win.start - cell.t_start
    steady(loop, warm_from - cell.t_start, warm, [(u.seconds, u.counts["device_steps"],
                                                   u.out["events"])
                                                  for u in win.units if not u.traced])
    peak = devices.peak(torch, dev)
    source = tokenizer.create_encoder(lang=src_lang, mode="source")
    served = collect(win, beams, encoded, sources, chunk, pool, n_chunks,
                     lambda text: tuple(int(x) for x in source(text))[:runtime.max_source_len])
    attempted = chunk * len(win.units)
    failed = attempted - len(served)
    n_tokens = sum(int(s["len"]) for s in served)
    totals = {k: sum(u.counts[k] for u in win.units) for k in win.units[0].counts}
    m = cfg["model"]
    layer_steps = (totals["device_steps"] * m["num_decoder_layers"]
                   // max(m["decoder_sparse_step"], 1))
    print(f"# {len(win.units)} calls; rows routed to the held experts: encoder "
          f"{totals['expert_rows.encoder']}, decoder {totals['expert_rows.decoder']}; a decoder "
          f"sparse layer-step: {totals['expert_hits.decoder'] / max(layer_steps, 1):.2f} of "
          f"{m['num_experts']} held experts with a row, "
          f"{totals['expert_rows.decoder'] / max(layer_steps * m['num_experts'], 1):.2f} rows "
          f"a held expert", file=sys.stderr)
    observations = observe(cfg, t, win, beams, encoded, loop, experts, len(prefix))
    del pipe, runtime, tokenizer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    texts = [s for c in pool for s in c]
    checks = compare(cell, cfg, t, tree, pieces, texts, served, list(prefix))
    return bench.Outcome(attempted=attempted, failed=failed,
                         metrics={"decode_tokens_per_s": n_tokens / win.seconds},
                         setup_s=setup_s, checks=checks, memory_peak_bytes=peak,
                         observations=observations, trace=win.summary)


def collect(win, beams: Beams, encoded: List[np.ndarray], sources: List[np.ndarray],
            chunk: int, pool: List[List[str]], n_chunks: int, key: Any) -> List[Dict[str, Any]]:
    """Every served row: its sentence's index in the pool, the text
    ``predict`` returned for it, and the hypotheses the search handed back.
    A batch row's sentence is the one whose source ids it holds (``key``:
    a text -> the program's ids of it)."""
    served, start = [], 0
    for u in win.units:
        end = u.out["marks"]
        recs, ids, lens = beams.batches[start:end], sources[start:end], encoded[start:end]
        start = end
        rows = [(b, r, s[r, :n[r]]) for b, s, n in zip(recs, ids, lens)
                for r in range(b["lens"].shape[0])]
        if len(recs) != len(ids) or len(rows) != len(u.out["texts"]) or len(rows) != chunk:
            continue  # a chunk that did not come back whole counts as failed
        where: Dict[tuple, List[int]] = {}
        for k, text in enumerate(pool[u.index % n_chunks]):
            where.setdefault(key(text), []).append(k)
        for b, r, src in rows:
            found = where.get(tuple(int(x) for x in src))
            if not found:
                continue  # a row of no sentence of the chunk is not served
            k = found.pop(0)
            served.append({"row": u.out["first"] + k, "text": u.out["texts"][k],
                           "len": b["lens"][r, 0],
                           "hyps": [(b["tokens"][r, h][: b["lens"][r, h]], b["scores"][r, h])
                                    for h in range(b["lens"].shape[1])]})
    return served


def observe(cfg: dict, t: dict, win, beams: Beams, encoded: List[np.ndarray], loop: Any,
            experts: Any, prefix_len: int) -> Dict[str, Any]:
    """What the per-layer readers read: the untraced units' wall time,
    counters, decode batches (sentences, device steps, true source
    lengths) and the loops' device time; the traced unit's expert calls."""
    plain = win.untraced()
    marks = [0] + [u.out["marks"] for u in win.units]
    ends = [0] + [u.out["encoded"] for u in win.units]
    batches = []
    for u in plain:
        recs = beams.batches[marks[u.index]:marks[u.index + 1]]
        lens = encoded[ends[u.index]:ends[u.index + 1]]
        if len(recs) != len(lens):
            return {}
        batches += [{"sentences": int(r["lens"].shape[0]), "steps": int(r["steps"]),
                     "source_lens": [int(x) for x in src]} for r, src in zip(recs, lens)]
    obs: Dict[str, Any] = {
        "model": cfg["model"], "seconds": sum(u.seconds for u in plain),
        "counts": {k: sum(u.counts.get(k, 0) for u in plain) for k in win.units[0].counts},
        "batches": batches, "beam_size": t["beam_size"], "prefix_len": prefix_len,
        "batch_pad": 1 << (t["batch_size"] - 1).bit_length()}
    if loop is not None:
        obs["loop_seconds"] = sum(loop.seconds(*u.out["events"]) for u in plain)
    traced = win.traced()
    if traced is not None and experts is not None:
        obs["expert_calls"] = experts.read()
    return obs


def compare(cell: bench.Cell, cfg: dict, t: dict, tree: dict, pieces, texts: List[str],
            served: List[Dict[str, Any]], prefix: List[int]) -> List[tuple]:
    ref = bench.reference(cfg)
    lim = cell.limits
    nan = float("nan")
    if not served:
        return [("score_gap", nan, lim.get("score_gap", nan))]
    n = min(t["sample"], len(served))
    longest = max(range(len(served)), key=lambda i: served[i]["len"])
    rest = [i for i in range(len(served)) if i != longest]
    picks = [longest] + [rest[i] for i in sorted(
        gen.rng_of(cell.seed, 7).choice(len(rest), min(n - 1, len(rest)), replace=False))]
    rows = [served[i] for i in picks]
    tok = spm.Tokenizer(pieces.pieces, pieces.scores, pieces.types, pieces.symbols)
    max_len = cfg["model"]["max_seq_len"]
    source = [tok.encode_source(texts[r["row"]], t["source_lang"])[:max_len] for r in rows]
    hyps = [(j, [int(x) for x in h], float(sc)) for j, r in enumerate(rows)
            for h, sc in r["hyps"]]
    sources = [source[j] for j, _, _ in hyps]
    seqs = [prefix + h[:-1] for _, h, _ in hyps]
    width, p = 2 * t["beam_size"], len(prefix)
    chosen = [len(h) - (len(h) == t["max_gen_len"] + 1) for _, h, _ in hyps]
    m = cfg["model"]
    tables = ref.log_probs(tree, m, sources, seqs, quant=cfg["precision"])
    if cell.control:
        lower = ref.log_probs(tree, m, sources, seqs, quant=cfg["control"]["precision"])
    got, want, picked = [], [], []
    for (_, h, sc), k, lp in zip(hyps, chosen, tables):
        want.append(ref.hypothesis_score(lp, p, h))
        if cell.control:
            lq = next(lower)
            got.append(ref.hypothesis_score(lq, p, h))
            picked.append(float(ref.kept_gaps(lp, lq, p, k, width).max()))
        else:
            got.append(sc)
            picked.append(float(ref.candidate_gaps(lp, p, h[:k], width).max()))
    gaps = [abs(g - w) for g, w in zip(got, want)]
    mismatch = sum(tok.decode([int(x) for x in r["hyps"][0][0]]) != r["text"] for r in rows)
    print(f"# score gaps over {len(gaps)} hypotheses: largest {max(gaps)!r}, root mean square "
          f"{float(np.sqrt(np.mean(np.square(gaps))))!r}; pick gaps: largest {max(picked)!r}, "
          f"hypotheses with one above 0: {sum(g > 0 for g in picked)}", file=sys.stderr)
    return [("score_gap", max(gaps), lim.get("score_gap", nan)),
            ("pick_gap", max(picked), lim.get("pick_gap", nan)),
            ("text_mismatch", float(mismatch), lim.get("text_mismatch", 0.0))]

