"""The flash backward's share of its roofline: the frozen bound (2.5 x the
forward's FLOPs) of every ops.attention call that needed a gradient over
the device time of the backward nodes joined to it, in %.  Moves
train_tokens_per_s."""
from portbench.metrics._common import ATTENTION as SPANS  # noqa: F401
from portbench.metrics._common import (  # noqa: F401
    flash_bwd_roofline_pct as read)
