"""idle_share (layer: device): the share of the traced unit's wall time in
which no operation ran on the device, 1 - (the union of the device
operations' intervals) / the unit's length, in %."""


def read(obs):
    trace = obs.get("trace")
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
