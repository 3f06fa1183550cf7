"""mfu.embed (layer: runtime): the least time the card needs for the
matmul work of the sentences encoded in the window's untraced units (their
true lengths, from the benchmark's span around the runtime's
``encode_batch``: int8 projections at 1,979 TOP/s, bf16 attention
contractions at 989 TFLOP/s), over those units' wall time, in %."""

from perfbench.harness import roofline


def read(obs):
    lens, seconds = obs.get("lens"), obs.get("seconds")
    if not lens or not seconds:
        return None
    m = obs["model"]
    ops = roofline.encoder_needed_ops(lens, m["model_dim"], m["ffn_inner_dim"],
                                      m["num_encoder_layers"])
    return 100.0 * sum(n / roofline.PEAK_OPS_S[k] for k, n in ops.items()) / seconds
