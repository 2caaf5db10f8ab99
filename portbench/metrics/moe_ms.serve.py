"""Device ms a batch of the kernels that `models.blocks.moe` launched in
the prefill.  Moves ttft_ms_p95."""
from portbench.metrics._common import forward_ms

SPANS = {"moe": "repro_torch.models.blocks:moe"}


def read(ctx):
    return forward_ms(ctx, ("moe",), "stretch_batches")
