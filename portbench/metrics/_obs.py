"""What the readers of the program's own tracer (`repro_torch.obs`)
share.  Loading such a reader turns the tracer on (`turn_on`):
`harness.readers` loads readers only in a traced run, after set-up and
just before the window, so an untraced run never turns it on.  The first
of them to read takes the records and counts into ctx["obs"] and turns
the tracer off again.  A reader skips the records of the window's first
`stretch_steps` steps or `stretch_batches` batches, which ran under the
profiler.  Against a program without the tracer each reads None."""

from __future__ import annotations

import statistics

try:
    from repro_torch import obs
except ImportError:   # a program without the tracer
    obs = None


def turn_on() -> None:
    if obs is not None:
        obs.enable()


def taken(ctx) -> dict | None:
    """{"records", "clock", "counters"} of the tracer, or None."""
    if "obs" not in ctx:
        if obs is None or not obs.enabled():
            ctx["obs"] = None
        else:
            ctx["obs"] = dict(obs.records(), counters=obs.counters())
            obs.disable()
    return ctx["obs"]


def host_lead_ms(ctx, mark: str, skip: str) -> float | None:
    """Median over the marks named `mark` after the stretch of the
    device's time reaching the mark's event less the host's time
    recording it, in ms (None without device times)."""
    got = taken(ctx)
    if not got:
        return None
    marks = [r for r in got["records"]
             if r.kind == "mark" and r.name == mark][ctx.get(skip) or 0:]
    leads = [(r.device_t0_ns - r.host_t0_ns) / 1e6 for r in marks
             if r.device_t0_ns is not None]
    return statistics.median(leads) if leads else None


def span_ms_per(ctx, name: str, per: str, skip: str) -> float | None:
    """Mean over the `per` spans after the stretch of the device ms of the
    `name` spans inside each (None where none has events)."""
    got = taken(ctx)
    if not got:
        return None
    recs = got["records"]   # a record's id is its index
    outer = [r for r in recs if r.kind == "span" and r.name == per][
        ctx.get(skip) or 0:]
    ms = {r.id: None for r in outer}
    for r in recs:
        if r.name != name or r.device_ms is None:
            continue
        up = r.parent
        while up is not None and recs[up].name != per:
            up = recs[up].parent
        if up in ms:
            ms[up] = (ms[up] or 0.0) + r.device_ms
    vals = [v for v in ms.values() if v is not None]
    return statistics.fmean(vals) if vals else None


def moe_counts(ctx) -> dict | None:
    got = taken(ctx)
    return got["counters"] if got else None
