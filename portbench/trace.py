"""Reduction of a profiled stretch to what the per-layer metrics read.

Input: the profiler's CPU events (a tree, with each event's own device
kernels' durations) and its device events (kernels, copies and sets, each
an interval), all in microseconds on one clock, and the stretch's window.

- busy: the union of the device intervals inside the window (one stream or
  many: overlapping kernels count once); idle = 1 - busy / window.
- A span "pb:<label>#<i>" owns the device time of the kernels launched
  under it and not under a span nested in it.
- Backward: the profiler gives each op that autograd records a sequence
  number, and each backward node's "autograd::engine::evaluate_function"
  event the same number and the forward thread.  A span's backward time is
  the device time of the evaluate_function events whose (sequence number,
  forward thread) an op of the span recorded, less any span nested in
  them (a recomputed forward under remat); each span keeps its own.
- Idle gaps are named, for the breakdown only, by what the host was
  doing: the time under the loop's `pb:wait` ranges (waits for arrivals)
  as the wait, the rest by the host event open where the gap began.
- Kernel names serve only the breakdown, never attribution.
"""

from __future__ import annotations

import dataclasses
import re

from portbench.spans import PREFIX

BACKWARD = "autograd::engine::evaluate_function"
SHORT_GAP_US = 20.0   # shorter idle gaps are summed under one name
WAIT = PREFIX + "wait"   # the benchmark's loop waiting for an arrival


@dataclasses.dataclass
class Ev:
    """A CPU event: name, [t0, t1) in us, thread, sequence number (-1:
    none), forward thread (of a backward event), the summed duration of the
    device work it launched itself, and its children."""
    name: str
    t0: float
    t1: float
    thread: int = 0
    seq: int = -1
    fwd_thread: int = 0
    kernel_us: float = 0.0
    children: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SpanTime:
    label: str
    index: int
    thread: int
    device_us: float          # own device time
    in_backward: bool         # opened inside a backward node (recompute)
    seqs: set
    t0: float = 0.0           # host time the span opened and closed
    t1: float = 0.0
    backward_us: float = 0.0  # device time of its joined backward


@dataclasses.dataclass
class Reduced:
    window_us: float
    busy_us: float
    spans: list               # SpanTime, in start order
    backward_us: dict         # label -> device us of its joined backward
    backward_joined: dict     # label -> backward events joined
    device_ops: list          # [(name, us)], most first
    idle_gaps: list           # [(host activity, us)], most first
    busy: list = dataclasses.field(default_factory=list)  # union, sorted

    def busy_between(self, lo: float, hi: float) -> float:
        """Device-busy us inside [lo, hi)."""
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in self.busy)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_us / self.window_us

    def forward(self, label: str) -> list[SpanTime]:
        return [s for s in self.spans if s.label == label]


def from_profiler(function_events) -> tuple[list[Ev], list[tuple]]:
    """(root CPU events, device intervals (t0, t1, name)) of
    `torch.profiler.profile(...).events()`."""
    from torch.autograd import DeviceType
    cpu, dev, made = [], [], {}
    for fe in function_events:
        if fe.device_type == DeviceType.CPU:
            made[id(fe)] = Ev(fe.name, fe.time_range.start, fe.time_range.end,
                              fe.thread, fe.sequence_nr,
                              getattr(fe, "fwd_thread", 0) or 0,
                              sum(k.duration for k in fe.kernels
                                  if not _annotation(k.name)))
        elif not (getattr(fe, "is_user_annotation", False)
                  or _annotation(fe.name)):
            dev.append((fe.time_range.start, fe.time_range.end, fe.name))
    for fe in function_events:
        ev = made.get(id(fe))
        if ev is None:
            continue
        parent = fe.cpu_parent
        if parent is not None and id(parent) in made:
            made[id(parent)].children.append(ev)
        else:
            cpu.append(ev)
    return cpu, dev


def _annotation(name: str) -> bool:
    """The device timeline's copy of a span: no device work of its own."""
    return name.startswith(PREFIX)


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """Disjoint, sorted union of intervals clipped to [lo, hi)."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _own(ev: Ev) -> tuple[float, set]:
    """Device us and sequence numbers of ev's subtree, nested spans left
    out."""
    us, seqs, stack = 0.0, set(), [ev]
    while stack:
        e = stack.pop()
        us += e.kernel_us
        if e.seq >= 0:
            seqs.add(e.seq)
        stack.extend(c for c in e.children if not c.name.startswith(PREFIX))
    return us, seqs


_SPAN = re.compile(re.escape(PREFIX) + r"(.+)#(\d+)$")


def reduce(roots: list[Ev], device: list[tuple], window: tuple[float, float],
           host_thread: int | None = None) -> Reduced:
    lo, hi = window
    spans: list[SpanTime] = []
    backward: list[Ev] = []
    host: list[tuple[float, float, int, str]] = []

    def walk(e: Ev, depth: int, in_bwd: bool) -> None:
        if e.name.startswith(BACKWARD):
            backward.append(e)
            in_bwd = True
        m = _SPAN.match(e.name)
        if m:
            us, seqs = _own(e)
            spans.append(SpanTime(m.group(1), int(m.group(2)), e.thread, us,
                                  in_bwd, seqs, e.t0, e.t1))
        if host_thread is None or e.thread == host_thread:
            host.append((e.t0, e.t1, depth, e.name))
        for c in e.children:
            walk(c, depth + 1, in_bwd)

    for r in roots:
        walk(r, 0, False)
    spans.sort(key=lambda s: s.index)

    by_key = {}
    for b in backward:
        if b.seq >= 0:
            by_key.setdefault((b.seq, b.fwd_thread), []).append(b)
    bwd_us, joined = {}, {}
    for s in spans:
        if s.in_backward:
            continue
        for q in s.seqs:
            for b in by_key.get((q, s.thread), ()):
                us = _own(b)[0]
                s.backward_us += us
                bwd_us[s.label] = bwd_us.get(s.label, 0.0) + us
                joined[s.label] = joined.get(s.label, 0) + 1

    busy = union([(a, b) for a, b, _ in device], lo, hi)
    busy_us = sum(b - a for a, b in busy)
    ops: dict[str, float] = {}
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ops[name] = ops.get(name, 0.0) + (b - a)
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    named = _name_gaps(gaps, host)
    return Reduced(
        window_us=hi - lo, busy_us=busy_us, spans=spans, backward_us=bwd_us,
        backward_joined=joined,
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(named.items(), key=lambda kv: -kv[1]), busy=busy)


def _name_gaps(gaps, host) -> dict[str, float]:
    """Idle time by what the host was doing: a gap's time under a WAIT
    range is the wait's, the rest goes to the deepest host event open at
    the gap's start (gaps under SHORT_GAP_US summed apart)."""
    import numpy as np
    named: dict[str, float] = {}
    short = sum(g1 - g0 for g0, g1 in gaps if g1 - g0 < SHORT_GAP_US)
    if short:
        named[f"(idle gaps under {SHORT_GAP_US:g} us)"] = short
    if not host:
        return named
    t0 = np.array([h[0] for h in host])
    t1 = np.array([h[1] for h in host])
    depth = np.array([h[2] for h in host], dtype=np.float64)
    waits = union([(h[0], h[1]) for h in host if h[3] == WAIT],
                  -np.inf, np.inf)
    for g0, g1 in gaps:
        if g1 - g0 < SHORT_GAP_US:
            continue
        waited = sum(max(0.0, min(b, g1) - max(a, g0)) for a, b in waits)
        if waited:
            named[WAIT] = named.get(WAIT, 0.0) + waited
        if waited >= g1 - g0:
            continue
        open_ = (t0 <= g0) & (t1 > g0)
        if open_.any():
            i = int(np.argmax(np.where(open_, depth, -1.0)))
            name = _SPAN.sub(lambda m: PREFIX + m.group(1), host[i][3])
        else:
            name = "(no host event)"
        named[name] = named.get(name, 0.0) + (g1 - g0 - waited)
    return named
