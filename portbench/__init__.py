"""The benchmark of `repro_torch` on NVIDIA H100s.

`run.py` is the command that `BENCHMARK.json` names.  Everything that
belongs to one architecture, configuration, traffic mix or per-layer
metric lives in a file of its own (`arch/`, `configs/`, `traffic/`,
`metrics/`, `limits/`, and the tiny twins of the CPU tests in
`tests/twins/`), found by the name that `BENCHMARK.json` or the
configuration gives it.  The yardsticks (traffic generation, operation
and byte counts, peaks, the profile's reduction, the plain reference and
the comparison that decides `correct`) live here, so that a change to the
program cannot move them.
"""
