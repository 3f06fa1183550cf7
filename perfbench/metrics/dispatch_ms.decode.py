"""dispatch_ms.decode (layer: runtime): the host's time to dispatch one
batch's beam decode in the traced call (upload, the captured setup's
replay, the loop's launch, the tail and the copies queued), the mean
``runtime.dispatch`` span of the program
(``TorchTextDecoder.generate_beam_async``, from
``sonar_tpu_torch.utils.profiling.last_recording()``), in ms. Nothing to
read in a program that records no such spans."""


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
    times = [s.end_ns - s.start_ns for s in rec.named("runtime.dispatch")]
    if not times:
        return None
    return 1e-6 * sum(times) / len(times)
