"""The benchmark of `repro_torch` on NVIDIA H100s.

`run.py` is the command that `BENCHMARK.json` names.  Everything that
belongs to one configuration, traffic mix or per-layer metric lives in a
file of its own (`configs/`, `traffic/`, `metrics/`, `limits/`), found by
the name that `BENCHMARK.json` gives it.  The yardsticks (traffic
generation, operation and byte counts, peaks, the profile's reduction, the
plain reference and the comparison that decides `correct`) live here, so
that a change to the program cannot move them.
"""
