"""moe_roofline.translate (layer: kernels): the expert GEMMs' share of their
roofline in the traced unit: the least time of every call of the program's
expert FFNs made outside a capture (the encoder's sparse layers;
``moe_work.experts_least_s`` of each call's rows a held expert, from its
group ends) over their device time (CUDA events around each call, which
also hold the bias adds and the ReLU between the two GEMMs), in %. Nothing
to read without a card, or in a program without ``nn.moe.experts``."""

from perfbench.harness import moe_work


def read(obs):
    calls = obs.get("expert_calls")
    if not calls:
        return None
    spent = sum(s for s, _ in calls)
    if spent <= 0:
        return None
    least = sum(moe_work.experts_least_s(obs["model"], rows) for _, rows in calls)
    return 100.0 * least / spent
