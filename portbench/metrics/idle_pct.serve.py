"""100 - the share of the profiled batches' service time (generate call to
token on the host) in which a kernel, copy or set ran on the device: the
idle that the host's launches and reads leave inside a request, waits for
arrivals left out.  Moves ttft_ms_p95."""
from portbench.metrics._common import idle_serve_pct as read  # noqa: F401
