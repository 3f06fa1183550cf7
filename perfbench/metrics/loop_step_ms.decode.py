"""loop_step_ms.decode (layer: device): the device's time a decoder step
in the traced call's beam loops, from the program's ``device.beam_loop``
spans (CUDA events around each launch of the loop on the card, with the
device steps the runtime counted for it, ``TorchTextDecoder.device_steps``'
own; ``sonar_tpu_torch.utils.profiling.last_recording()``): the loops'
total time over their steps, in ms. ``decode_step_ms`` less this is the
host's share of a step. Nothing to read without a card, or in a program
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
    loops = rec.named("device.beam_loop")
    steps = sum(s.attrs.get("steps", 0) for s in loops)
    if not loops or steps <= 0:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in loops) / steps
