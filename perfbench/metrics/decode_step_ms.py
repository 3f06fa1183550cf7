"""decode_step_ms (layer: runtime): the window's untraced wall time over
the decoder steps the device ran in it (the program's
``TorchTextDecoder.device_steps``), in ms."""


def read(obs):
    steps = obs.get("counts", {}).get("device_steps")
    if not steps or not obs.get("seconds"):
        return None
    return 1e3 * obs["seconds"] / steps
