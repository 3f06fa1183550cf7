"""mfu.speech (layer: runtime): the bf16 matmul work the clips encoded in
the window's untraced units need (``speech_work.encoder_needed_flops`` of
their true Conformer lengths, from the program's ``TorchSpeechEncoder.
stats``: ``clips``, ``true_seq``, ``true_seq_sq``) at 989 TFLOP/s, over
those units' wall time, in %. Nothing to read in a program without the
counter."""

from perfbench.harness import roofline, speech_work


def read(obs):
    c, seconds = obs.get("counts", {}), obs.get("seconds")
    if not c.get("true_seq") or not seconds:
        return None
    flops = speech_work.encoder_needed_flops(obs["model"], c["clips"], c["true_seq"],
                                             c["true_seq_sq"])
    return 100.0 * flops / roofline.PEAK_OPS_S["bf16"] / seconds
