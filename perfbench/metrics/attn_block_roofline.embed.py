"""attn_block_roofline.embed (layer: kernels): ``fused_attn_block``'s
share of its roofline in the traced unit: the least time of its launches
(from the batches' shapes, one launch a layer) over the profiler's device
time of its kernels, in %. Nothing to read unless the trace holds as many
launches as the program's counter counted and as the batches need."""

from perfbench.harness import kernels, roofline


def read(obs):
    trace, traced = obs.get("trace"), obs.get("traced")
    if trace is None or traced is None:
        return None
    times = kernels.launches(trace.kernels, kernels.ATTN_BLOCK_EPI)
    m = obs["model"]
    layers, d = m["num_encoder_layers"], m["model_dim"]
    # the batches the block kernels' gate admits
    shapes = [(b, s) for b, s in traced["shapes"] if 8 <= s <= 128 and b * s >= 2048]
    counted = traced["counts"].get("launches.attn_block", 0)
    if not times or len(times) != counted or counted != layers * len(shapes):
        return None
    least = sum(layers * roofline.bound_s(*roofline.attn_block_work(b, s, d)) for b, s in shapes)
    return 100.0 * least / sum(times)
