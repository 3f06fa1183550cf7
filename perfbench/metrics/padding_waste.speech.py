"""padding_waste.speech (layer: pipeline): the share of the Conformer
positions run that are padding, 1 - true / padded (the clips' encoder
lengths against each batch's rows x its wave bucket's S), over the window's
untraced units, from the program's own counter (``TorchSpeechEncoder.
stats``), in %."""


def read(obs):
    c = obs.get("counts", {})
    if not c.get("padded_seq"):
        return None
    return 100.0 * (1.0 - c["true_seq"] / c["padded_seq"])
