"""relpos_roofline.speech (layer: kernels): ``relpos_flash_attention_v2``'s
(#6) share of its roofline in the traced unit: the least time of its
launches (``speech_work.relpos_work`` at each batch's rows and S, from the
program's ``runtime.enqueue`` spans, one launch a Conformer layer for each
batch of 128 <= S <= 2048, the kernel's gate) over the profiler's device
time of its ``relpos_v2_rt_kernel`` kernels (a launch runs one a workspace
chunk of rows), in %. Nothing to read unless the program's launch counter
counted as many launches as those batches need, or in a program that
records no such spans."""

from perfbench.harness import speech_work

KERNEL = "relpos_v2_rt_kernel"


def read(obs):
    trace, traced = obs.get("trace"), obs.get("traced")
    if trace is None or traced is None:
        return None
    try:
        from sonar_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    if rec is None:
        return None
    m = obs["model"]
    layers, d, h = m["num_encoder_layers"], m["model_dim"], m["num_encoder_attn_heads"]
    shapes = [(s.attrs.get("rows", 0), s.attrs.get("length", 0))
              for s in rec.named("runtime.enqueue")]
    shapes = [(b, n) for b, n in shapes if 128 <= n <= 2048]
    times = [dur for name, _, dur in trace.kernels if KERNEL in name]
    counted = traced["counts"].get("launches.relpos", 0)
    if not shapes or counted != layers * len(shapes) or len(times) < counted:
        return None
    least = sum(layers * speech_work.relpos_least_s(b, h, n, d // h, d) for b, n in shapes)
    return 100.0 * least / sum(times)
