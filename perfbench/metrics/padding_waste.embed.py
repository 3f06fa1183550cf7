"""padding_waste.embed (layer: pipeline): the share of the encoded tokens
that are padding, 1 - true / padded, over the window's untraced units, from
the program's own counter (``TorchTextEncoder.stats``), in %."""


def read(obs):
    c = obs.get("counts", {})
    if not c.get("padded_tokens"):
        return None
    return 100.0 * (1.0 - c["true_tokens"] / c["padded_tokens"])
