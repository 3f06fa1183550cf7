"""Entry driver: bulk text -> embedding through the public pipeline.

Set-up draws the tokenizer and the weights from the seed, builds the
configuration's ``TextToEmbeddingModelPipeline``, makes the traffic's pool
of raw sentences, and warms the static shapes the traffic's lengths fall
into (``TorchTextEncoder.warmup``) and the tokenizer (one short
``predict``). The window calls ``predict(chunk, source_lang, batching)``
on chunk after chunk (the pool cycled); ``embeddings_per_s`` is every row
returned over the window's whole time, host tokenisation included.

``correct``: once the window has closed and the program is freed, the
plain reference tokenises a sample of the returned sentences again (drawn
from the seed, the window's longest among them) and encodes them in fp32
with the configuration's int8 quantisation; ``emb_rel_err`` is the largest
||program - reference|| / ||reference|| over the sample.
"""

from __future__ import annotations

import gc
import sys
from typing import Any, Dict, List

import numpy as np
from perfbench.harness import bench, counters, devices, spans, traffic as gen, weights
from perfbench.harness import tokenizer as tokens
from perfbench.harness.window import chunked
from perfbench.reference import spm

KEEP_PER_UNIT = 32  # rows of each unit kept for the sample (plus its longest)


def used_buckets(static_buckets, max_len: int, lo: int, hi: int) -> List[int]:
    """The static length buckets that sentences of lo..hi tokens fill, and
    the next one (a sparse remainder batch is promoted into it)."""
    buckets = [b for b in static_buckets if b < max_len] + [max_len]
    first = next(i for i, b in enumerate(buckets) if b >= lo)
    last = next((i for i, b in enumerate(buckets) if b >= hi), len(buckets) - 1)
    return buckets[first:min(last + 2, len(buckets))]


def run(cell: bench.Cell) -> bench.Outcome:
    import torch

    from sonar_tpu_torch.inference_pipelines.text import STATIC_LEN_BUCKETS

    cfg, t, dev = cell.config, cell.traffic, cell.device
    system = bench.load_module(bench.PACKAGE / "systems" / f"{cfg['system']}.py")
    pieces = tokens.draw(cell.seed, cfg["model"]["vocab_info"]["size"])
    tokenizer = tokens.program_tokenizer(pieces)
    tree = weights.text_encoder(torch, cfg["model"], cell.seed,
                                getattr(torch, cfg["runtime"]["dtype"]), dev)
    pipe, encoder = system.build(torch, cfg, tree, tokenizer, dev)
    chunk = cell.scale.get("chunk", t["chunk"])
    pool = gen.text_pool(pieces.words, t["lengths"], chunk,
                         cell.scale.get("pool_chunks", t["pool_chunks"]), cell.seed)
    lang, batching = t["lang"], t["batching"]
    lengths = t["lengths"]
    encoder.warmup(len_buckets=used_buckets(STATIC_LEN_BUCKETS, encoder.max_source_len,
                                            lengths["min"], lengths["max"]))
    pipe.predict(pool[0][: min(1024, chunk)], source_lang=lang, batching=batching)
    batches = spans.Batches(encoder) if cell.trace else None
    devices.reset_peak(torch, dev)

    rng = gen.rng_of(cell.seed, 5)
    kept: List[tuple] = []  # (text, embedding row)

    def call(i: int) -> Dict[str, Any]:
        texts = pool[i % len(pool)]
        emb = pipe.predict(texts, source_lang=lang, batching=batching)
        good = np.isfinite(emb).all(axis=1) if emb.shape == (len(texts), emb.shape[-1]) \
            else np.zeros(len(texts), bool)
        rows = set(rng.choice(len(texts), min(KEEP_PER_UNIT, len(texts)), replace=False).tolist())
        rows.add(int(np.argmax([len(s) for s in texts])))
        kept.extend((texts[r], emb[r].copy()) for r in sorted(rows) if r < len(emb))
        return {"rows": len(emb), "good": int(good.sum()), "texts": len(texts),
                "marks": batches.mark() if batches else 0}

    def count() -> Dict[str, float]:
        s = encoder.stats.snapshot()
        out = {"true_tokens": s["true_tokens"], "padded_tokens": s["padded_tokens"],
               "batches": s["batches"]}
        if dev.type == "cuda":
            out.update(counters.launches())
        return out

    win = chunked(torch, dev, cell.seconds, cell.trace, call, count)
    setup_s = win.start - cell.t_start
    rates = [u.out["rows"] / u.seconds for u in win.untraced()]
    print(f"# {len(win.units)} calls; embeddings/s a call: " + " ".join(f"{r:.0f}" for r in rates),
          file=sys.stderr)
    attempted = sum(u.out["texts"] for u in win.units)
    failed = attempted - sum(u.out["good"] for u in win.units)
    returned = sum(u.out["rows"] for u in win.units)
    peak = devices.peak(torch, dev)
    max_len = encoder.max_source_len
    observations = observe(cfg, win, batches)
    del pipe, encoder, tokenizer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows = sample(kept, cell.scale.get("sample", t["sample"]), cell.seed, 6)
    checks = embedding_error(cell, tree, pieces, rows, max_len)
    return bench.Outcome(attempted=attempted, failed=failed,
                         metrics={"embeddings_per_s": returned / win.seconds}, setup_s=setup_s,
                         checks=checks, memory_peak_bytes=peak, observations=observations,
                         trace=win.summary)


def observe(cfg: dict, win, batches) -> Dict[str, Any]:
    """What the per-layer readers read: the untraced units' time, counts and
    batches; the traced unit's batches and launches."""
    plain = win.untraced()
    obs: Dict[str, Any] = {"model": cfg["model"], "window_s": win.seconds,
                           "seconds": sum(u.seconds for u in plain),
                           "counts": {k: sum(u.counts.get(k, 0) for u in plain)
                                      for k in win.units[0].counts}}
    if batches is None:
        return obs
    bounds = [0] + [u.out["marks"] for u in win.units]
    spans_of = {u.index: (bounds[u.index], bounds[u.index + 1]) for u in win.units}
    obs["lens"] = [n for u in plain for b in range(*spans_of[u.index])
                   for n in batches.lens[b].tolist()]
    traced = win.traced()
    if traced is not None:
        lo, hi = spans_of[traced.index]
        obs["traced"] = {"shapes": batches.shapes[lo:hi], "counts": traced.counts}
    return obs


def sample(rows: List[tuple], n: int, seed: int, stream: int) -> List[tuple]:
    """``n`` of ``rows`` (text, ...) drawn from the seed, the longest text
    first."""
    longest = max(range(len(rows)), key=lambda i: len(rows[i][0]))
    rest = [i for i in range(len(rows)) if i != longest]
    picks = gen.rng_of(seed, stream).choice(len(rest), min(n - 1, len(rest)), replace=False)
    return [rows[longest]] + [rows[rest[i]] for i in sorted(picks)]


def embedding_error(cell: bench.Cell, tree: dict, pieces, rows: List[tuple],
                    max_len: int) -> List[tuple]:
    """``emb_rel_err`` of the served (text, embedding) ``rows``: the largest
    ||program - reference|| / ||reference||, the reference tokenising each
    text again and encoding it with the configuration's precision (with
    ``--control``, the control's precision in the program's place)."""
    import torch

    cfg = cell.config
    ref = bench.reference(cfg)
    tok = spm.Tokenizer(pieces.pieces, pieces.scores, pieces.types, pieces.symbols)
    ids = [tok.encode_source(text, cell.traffic["lang"])[:max_len] for text, _ in rows]
    want = ref.embed(tree, cfg["model"], ids, quant=cfg["precision"])
    if cell.control:
        got = ref.embed(tree, cfg["model"], ids, quant=cfg["control"]["precision"])
    else:
        got = torch.as_tensor(np.stack([e for _, e in rows]), device=want.device).float()
    err = (torch.linalg.vector_norm(got - want, dim=1)
           / torch.linalg.vector_norm(want, dim=1)).max().item()
    return [("emb_rel_err", float(err), float(cell.limits.get("emb_rel_err", float("nan"))))]
