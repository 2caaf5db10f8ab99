"""The share of the expert buffers' rows that held a kept (token, slot)
pair, over the whole traced window: the port's MoE counters
(`repro_torch.obs.count_moe`, after `blocks.route`), kept pairs over E x
G x C rows, in %.  The rest of the expert GEMMs' rows is padding.
Moves ttft_ms_p95."""
from portbench.metrics import _obs

_obs.turn_on()


def read(ctx):
    c = _obs.moe_counts(ctx)
    if not c or not c["moe.buffer_rows"]:
        return None
    return 100.0 * c["moe.kept_pairs"] / c["moe.buffer_rows"]
