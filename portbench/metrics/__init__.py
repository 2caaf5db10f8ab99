"""Per-layer metric readers, one file a metric: `<metric>.py`."""
