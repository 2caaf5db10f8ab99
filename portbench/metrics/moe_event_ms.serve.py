"""Device ms of the MoE blocks in a batch's prefill, by CUDA events: each
`moe` span of the port's tracer (`repro_torch.obs`, one a block) from its
start event to its end event on the device's clock, summed over the
blocks under a `generate` span; the mean over the traced run's batches
after the profiled stretch (the 9-length cycle repeats).  Stream time
between two events: it includes any idle inside a block, small in
service.  Moves ttft_ms_p95."""
from portbench.metrics import _obs

_obs.turn_on()


def read(ctx):
    return _obs.span_ms_per(ctx, "moe", "generate", "stretch_batches")
