"""100 - the share of the profiled stretch in which a kernel, copy or set
ran on the device (their union).  Moves train_tokens_per_s."""
from portbench.metrics._common import idle_pct as read  # noqa: F401
