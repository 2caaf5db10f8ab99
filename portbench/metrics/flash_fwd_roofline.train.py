"""The flash forward's share of its roofline in training: the frozen
bound of every ops.attention forward call (recomputed ones too) over their
device time, in %.  Moves train_tokens_per_s."""
from portbench.metrics._common import ATTENTION as SPANS  # noqa: F401
from portbench.metrics._common import (  # noqa: F401
    flash_fwd_roofline_pct as read)
