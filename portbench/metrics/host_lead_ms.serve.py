"""How far the host leads the device in a prefill: at the mark the port's
`generate` records once it has enqueued its last op, before any readback
("generate.enqueued", `repro_torch.obs`), the device's time reaching that
event less the host's time recording it; the median over the traced
run's batches after the profiled stretch.  Moves ttft_ms_p95."""
from portbench.metrics import _obs

_obs.turn_on()


def read(ctx):
    return _obs.host_lead_ms(ctx, "generate.enqueued", "stretch_batches")
