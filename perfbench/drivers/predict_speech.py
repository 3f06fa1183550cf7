"""Entry driver: in-memory waveforms -> embeddings through the public speech
pipeline.

Set-up draws the weights from the seed, builds the configuration's
``SpeechToEmbeddingModelPipeline``, makes the traffic's pool of clips (16 kHz
mono float32 arrays held in memory: a tone of 100-800 Hz plus noise, from
the seed; durations the quantiles of the traffic's distribution, so every
seed asks for the same work, reordered), and warms every wave bucket up to
the longest clip at the traffic's batch size (``TorchSpeechEncoder.warmup``)
and the pipeline (one ``predict`` on the first chunk). The window calls
``predict(chunk, batch_size)`` on chunk after chunk (the pool cycled;
``predict`` sorts a chunk by length and returns it in input order);
``embeddings_per_s`` is every row returned over the window's whole time,
host work included.

The driver reads the program's counters itself around each call:
``TorchSpeechEncoder.stats`` (where the program has it), the rel-pos
kernel's launches (``relpos_flash.LAUNCHES``) and the Conformer's plain
rel-pos calls (``conformer.PLAIN_CALLS``, printed: sorted batches of 16
pad to at least the 4-s bucket, S 199, inside the kernel's gate).

At a test's scale (``cell.scale`` given, on the CPU) clips are capped at
``TEST_MAX_SAMPLES`` so that a run takes seconds; a measured run never is.

``correct``: once the window has closed and the program is freed, the
plain reference encodes a sample of the returned clips (drawn from the
seed, the window's longest first) from their waveforms in fp32;
``emb_rel_err`` is the largest ||program - reference|| / ||reference||
over the sample.
"""

from __future__ import annotations

import gc
import sys
from typing import Any, Dict, List

import numpy as np
from perfbench.drivers.predict_embed import KEEP_PER_UNIT, sample
from perfbench.harness import bench, devices, traffic as gen, weights_speech
from perfbench.harness.window import chunked

TEST_MAX_SAMPLES = 96000  # 6 s
STATS = ("clips", "batches", "true_seq", "true_seq_sq", "padded_seq")


def clip_pool(spec: dict, rate: int, chunk: int, chunks: int, seed: int
              ) -> List[List[np.ndarray]]:
    """``chunks`` chunks of ``chunk`` clips, lengths (samples) as ``spec``."""
    rng = gen.rng_of(seed, 4)
    lens = gen.token_lengths(spec, chunk * chunks)
    rng.shuffle(lens)
    clips = []
    for n in lens.tolist():
        t = np.arange(n, dtype=np.float32) / np.float32(rate)
        tone = np.sin(np.float32(2 * np.pi * rng.uniform(100, 800)) * t)
        clips.append(np.float32(0.3) * tone
                     + np.float32(0.05) * rng.standard_normal(n, dtype=np.float32))
    return [clips[i * chunk:(i + 1) * chunk] for i in range(chunks)]


def run(cell: bench.Cell) -> bench.Outcome:
    import torch

    from sonar_tpu_torch.nn import conformer
    from sonar_tpu_torch.ops.cuda import relpos_flash

    cfg, t, dev = cell.config, cell.traffic, cell.device
    system = bench.load_module(bench.PACKAGE / "systems" / f"{cfg['system']}.py")
    tree = weights_speech.speech_encoder(torch, cfg["model"], cell.seed,
                                         getattr(torch, cfg["runtime"]["dtype"]), dev)
    pipe, encoder = system.build(torch, cfg, tree, dev)
    spec = dict(t["durations"])
    if cell.scale:
        spec["max"] = min(spec["max"], TEST_MAX_SAMPLES)
    chunk = cell.scale.get("chunk", t["chunk"])
    pool = clip_pool(spec, t["sample_rate"], chunk,
                     cell.scale.get("pool_chunks", t["pool_chunks"]), cell.seed)
    batch = t["batch_size"]
    encoder.warmup(batch_size=batch, max_wave_len=min(t["warm_max_wave_len"], spec["max"]))
    pipe.predict(pool[0], batch_size=batch)
    devices.reset_peak(torch, dev)

    rng = gen.rng_of(cell.seed, 5)
    kept: List[tuple] = []  # (waveform, embedding row)

    def call(i: int) -> Dict[str, Any]:
        clips = pool[i % len(pool)]
        emb = pipe.predict(clips, batch_size=batch)
        good = np.isfinite(emb).all(axis=1) if emb.shape == (len(clips), emb.shape[-1]) \
            else np.zeros(len(clips), bool)
        rows = set(rng.choice(len(clips), min(KEEP_PER_UNIT, len(clips)), replace=False).tolist())
        rows.add(int(np.argmax([len(c) for c in clips])))
        kept.extend((clips[r], emb[r].copy()) for r in sorted(rows) if r < len(emb))
        return {"rows": len(emb), "good": int(good.sum()), "clips": len(clips)}

    def count() -> Dict[str, float]:
        out = {"launches.relpos": relpos_flash.LAUNCHES, "plain_calls": conformer.PLAIN_CALLS}
        stats = getattr(encoder, "stats", None)  # the program's own counter, where it has one
        if stats is not None:
            snap = stats.snapshot()
            out.update((k, snap[k]) for k in STATS)
        return out

    win = chunked(torch, dev, cell.seconds, cell.trace, call, count)
    setup_s = win.start - cell.t_start
    rates = [u.out["rows"] / u.seconds for u in win.untraced()]
    print(f"# {len(win.units)} calls; embeddings/s a call: " + " ".join(f"{r:.1f}" for r in rates),
          file=sys.stderr)
    totals = {k: sum(u.counts[k] for u in win.units) for k in ("launches.relpos", "plain_calls")}
    print(f"# rel-pos attention in the window: {totals['launches.relpos']} launches of "
          f"relpos_flash_attention_v2, {totals['plain_calls']} plain calls "
          f"(conformer.PLAIN_CALLS)", file=sys.stderr)
    attempted = sum(u.out["clips"] for u in win.units)
    failed = attempted - sum(u.out["good"] for u in win.units)
    returned = sum(u.out["rows"] for u in win.units)
    peak = devices.peak(torch, dev)
    observations = observe(cfg, win)
    del pipe, encoder
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows = sample(kept, cell.scale.get("sample", t["sample"]), cell.seed, 6)
    checks = embedding_error(cell, tree, rows)
    return bench.Outcome(attempted=attempted, failed=failed,
                         metrics={"embeddings_per_s": returned / win.seconds}, setup_s=setup_s,
                         checks=checks, memory_peak_bytes=peak, observations=observations,
                         trace=win.summary)


def observe(cfg: dict, win) -> Dict[str, Any]:
    """What the per-layer readers read: the untraced units' time and counts
    and the traced unit's counts."""
    plain = win.untraced()
    obs: Dict[str, Any] = {"model": cfg["model"], "window_s": win.seconds,
                           "seconds": sum(u.seconds for u in plain),
                           "counts": {k: sum(u.counts.get(k, 0) for u in plain)
                                      for k in win.units[0].counts}}
    traced = win.traced()
    if traced is not None:
        obs["traced"] = {"counts": traced.counts}
    return obs


def embedding_error(cell: bench.Cell, tree: dict, rows: List[tuple]) -> List[tuple]:
    """``emb_rel_err`` of the served (waveform, embedding) ``rows``: the
    largest ||program - reference|| / ||reference||, the reference encoding
    each waveform in the configuration's precision (with ``--control``, the
    control's precision in the program's place)."""
    import torch

    cfg = cell.config
    ref = bench.reference(cfg)
    waves = [w for w, _ in rows]
    want = ref.embed(tree, cfg["model"], waves, quant=cfg["precision"])
    if cell.control:
        got = ref.embed(tree, cfg["model"], waves, quant=cfg["control"]["precision"])
    else:
        got = torch.as_tensor(np.stack([e for _, e in rows]), device=want.device).float()
    err = (torch.linalg.vector_norm(got - want, dim=1)
           / torch.linalg.vector_norm(want, dim=1)).max().item()
    return [("emb_rel_err", float(err), float(cell.limits.get("emb_rel_err", float("nan"))))]
