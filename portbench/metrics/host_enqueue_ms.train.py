"""Host ms of one call of the training step, before any sync (median over
the traced run's steps outside the profiled stretch): a span in the
benchmark's own loop.  Moves train_tokens_per_s."""
from portbench.metrics._common import host_ms as read  # noqa: F401
