"""enqueue_ms.embed (layer: runtime): the host's time to enqueue one batch
on the device in the traced call, the mean ``runtime.enqueue`` span of the
program (``TorchTextEncoder.encode_batch``, from
``sonar_tpu_torch.utils.profiling.last_recording()``), in ms. At or above
the device's time a batch (``busy_s`` over the batches) the encoder is
launch-bound. Nothing to read in a program that records no such spans."""


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
    times = [s.end_ns - s.start_ns for s in rec.named("runtime.enqueue")]
    if not times:
        return None
    return 1e-6 * sum(times) / len(times)
