"""mfu.translate (layer: runtime): the matrix FLOPs the translations in the
window's untraced units need (``moe_work.encoder_flops`` of the true source
lengths and ``moe_work.decoder_flops`` of each batch's device steps, both
with the held experts' routed rows of the program's counters,
``NllbMoeModel.read_counters``) at 989 TFLOP/s, over those units' wall
time, in %. Nothing to read without the counters or the batches."""

from perfbench.harness import moe_work, roofline


def read(obs):
    batches, seconds, c = obs.get("batches"), obs.get("seconds"), obs.get("counts", {})
    if not batches or not seconds or "expert_rows.encoder" not in c:
        return None
    m = obs["model"]
    lens = [n for b in batches for n in b["source_lens"]]
    flops = (moe_work.encoder_flops(m, lens, c["expert_rows.encoder"])
             + moe_work.decoder_flops(m, batches, obs["beam_size"], obs["prefix_len"],
                                      c["expert_rows.decoder"]))
    return 100.0 * flops / roofline.PEAK_OPS_S["bf16"] / seconds
