"""hbm_roofline.translate (layer: runtime): the least bytes the search's loop
reads in the window's untraced units (``moe_work.loop_bytes``: the decoder's
weights once a step, only the held experts that got a row, by the program's
``expert_hits`` counter over its decoder steps; the tied table; the self
cache up to each step's position; the source K/V once a sentence) at 3.35
TB/s, over the loops' device time (CUDA events around each launch of the
loop), in %. Nothing to read without a card, the counters or the batches."""

from perfbench.harness import moe_work, roofline


def read(obs):
    batches, loop_s, c = obs.get("batches"), obs.get("loop_seconds"), obs.get("counts", {})
    if not batches or not loop_s or "expert_hits.decoder" not in c or not c.get("device_steps"):
        return None
    m = obs["model"]
    sparse = moe_work.sparse_layers(m["num_decoder_layers"], m["decoder_sparse_step"])
    hits = c["expert_hits.decoder"] / (sparse * c["device_steps"])
    moved = moe_work.loop_bytes(m, batches, obs["prefix_len"], hits)
    return 100.0 * moved / roofline.HBM_BYTES_S / loop_s
