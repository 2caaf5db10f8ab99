"""The share of valid routed (token, slot) pairs that the port drops over
an expert's capacity, over the whole traced window: the port's MoE
counters (`repro_torch.obs.count_moe`, after `blocks.route`), (valid -
kept) over valid pairs, in %.  Moves ttft_ms_p95."""
from portbench.metrics import _obs

_obs.turn_on()


def read(ctx):
    c = _obs.moe_counts(ctx)
    if not c or not c["moe.valid_pairs"]:
        return None
    return 100.0 * (c["moe.valid_pairs"] - c["moe.kept_pairs"]) \
        / c["moe.valid_pairs"]
