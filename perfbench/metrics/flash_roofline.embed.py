"""flash_roofline.embed (layer: kernels): ``flash_attention``'s share of
its roofline in the traced unit: the least time of its launches (q, k, v
of each batch's shape, one launch a layer) over the profiler's device time
of its kernel, in %. Nothing to read unless the trace holds as many
launches as the program's counter counted and as the batches need."""

from perfbench.harness import kernels, roofline


def read(obs):
    trace, traced = obs.get("trace"), obs.get("traced")
    if trace is None or traced is None:
        return None
    times = kernels.flash(trace.kernels)
    m = obs["model"]
    layers, d, h = m["num_encoder_layers"], m["model_dim"], m["num_encoder_attn_heads"]
    # the batches the kernel's gate admits
    shapes = [(b, s) for b, s in traced["shapes"] if s >= 256]
    counted = traced["counts"].get("launches.flash", 0)
    if not times or len(times) != counted or counted != layers * len(shapes):
        return None
    least = sum(layers * roofline.bound_s(*roofline.flash_work(b, h, s, d // h))
                for b, s in shapes)
    return 100.0 * least / sum(times)
