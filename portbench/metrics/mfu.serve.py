"""Model FLOPs of the profiled batches' prefills
(portbench.flops.prefill_flops) over the seconds those batches were in
service (generate call to token on the host; waits for arrivals left out)
and the H100's 989 TFLOP/s bf16, in %.  Moves ttft_ms_p95."""
from portbench.metrics._common import mfu_serve_pct as read  # noqa: F401
