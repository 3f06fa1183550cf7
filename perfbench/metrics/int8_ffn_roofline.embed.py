"""int8_ffn_roofline.embed (layer: kernels): ``fused_int8_ffn``'s share of
its roofline in the traced unit: the least time of its launches (from the
batches' shapes, one launch a layer) over the profiler's device time of
its kernels, in %. Nothing to read unless the trace holds as many launches
as the program's counter counted and as the batches need."""

from perfbench.harness import kernels, roofline


def read(obs):
    trace, traced = obs.get("trace"), obs.get("traced")
    if trace is None or traced is None:
        return None
    times = kernels.launches(trace.kernels, kernels.FFN_EPI)
    m = obs["model"]
    layers, d, f = m["num_encoder_layers"], m["model_dim"], m["ffn_inner_dim"]
    # the batches the kernel's gate admits
    shapes = [(b, s) for b, s in traced["shapes"] if b * s >= 2048]
    counted = traced["counts"].get("launches.int8_ffn", 0)
    if not times or len(times) != counted or counted != layers * len(shapes):
        return None
    least = sum(layers * roofline.bound_s(*roofline.int8_ffn_work(b * s, d, f))
                for b, s in shapes)
    return 100.0 * least / sum(times)
