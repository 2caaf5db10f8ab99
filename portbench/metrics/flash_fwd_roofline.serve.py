"""The flash forward's share of its roofline in prefill, in %.  Moves
ttft_ms_p95."""
from portbench.metrics._common import ATTENTION as SPANS  # noqa: F401
from portbench.metrics._common import (  # noqa: F401
    flash_fwd_roofline_pct as read)
