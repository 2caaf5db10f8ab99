"""Model FLOPs of the profiled steps (portbench.flops.train_step_flops)
over the stretch's seconds and the H100's 989 TFLOP/s bf16, in %.  Moves
train_tokens_per_s."""
from portbench.metrics._common import mfu_pct as read  # noqa: F401
