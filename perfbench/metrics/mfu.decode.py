"""mfu.decode (layer: runtime): the matmul FLOPs of the decoder steps the
device ran in the window's untraced units (``decoder_step_flops`` at the
padded batch times the beam, each step at its cache length; the steps of
each decode from the program's ``device_steps``) at 989 TFLOP/s, over those
units' wall time, in %."""

from perfbench.harness import roofline


def read(obs):
    steps, seconds = obs.get("decode_steps"), obs.get("seconds")
    if not steps or not seconds:
        return None
    m = obs["model"]
    flops = roofline.decode_flops(steps, obs["rows"], m["model_dim"], m["ffn_inner_dim"],
                                  m["num_decoder_layers"], m["vocab_info"]["size"])
    return 100.0 * flops / roofline.PEAK_OPS_S["bf16"] / seconds
