"""host_wait_share.embed (layer: pipeline): the share of the traced call's
wall time in which the encoder waited on the host pipeline, from the
program's own spans (``sonar_tpu_torch.utils.profiling.last_recording()``):
the ``pipeline.wait`` spans (the consumer's wait on the prefetch queue)
over the ``pipeline.predict`` spans, in %. Nothing to read in a program
that records no such spans."""


def read(obs):
    if obs.get("trace") is None:
        return None
    try:
        from sonar_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_recording", None)
    rec = last() if last is not None else None
    if rec is None:
        return None
    wall = sum(s.end_ns - s.start_ns for s in rec.named("pipeline.predict"))
    if wall <= 0:
        return None
    waits = sum(s.end_ns - s.start_ns for s in rec.named("pipeline.wait"))
    return 100.0 * waits / wall
