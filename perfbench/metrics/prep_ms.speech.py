"""prep_ms.speech (layer: pipeline): the host's time to prepare one batch
for the device in the traced call, the program's ``pipeline.batch`` (padding
the clips into their wave bucket) plus ``runtime.upload`` spans over the
batches (``TorchSpeechEncoder.encode_waveforms``, from
``sonar_tpu_torch.utils.profiling.last_recording()``), in ms: the device
waits for the host through it. Nothing to read in a program that records
no such spans."""


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
    batches = rec.named("pipeline.batch")
    if not batches:
        return None
    spans = batches + rec.named("runtime.upload")
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / len(batches)
