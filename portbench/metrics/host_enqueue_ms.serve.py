"""Host ms of one `generate` call before its token is read (median over
the traced run's batches outside the profiled stretch).  Moves
ttft_ms_p95."""
from portbench.metrics._common import host_ms as read  # noqa: F401
