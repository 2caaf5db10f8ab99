"""The port's tracer: spans, marks and counters at the layer boundaries of
training and serving.  Off by default.

Off, `span` returns one shared no-op context manager, and `mark` and
`count_moe` return at once: a flag check a site, and no site sits inside
a per-token or per-element loop.  `enable` turns it on, `disable` turns
it off; both drop what was kept, as `reset` does.

On, a span keeps its name, id, parent's id, attributes and host start and
end (`time.perf_counter_ns`), and, where the tensor handed to it is a real
CUDA tensor, a CUDA timing event recorded on the current stream at each
end.  A mark is one such point.  Nothing is written out: `records()` hands
the records over.  While a `torch.profiler` records, each span also opens
a host-side range of its name (a function-scope `RecordFunction`: no
`gpu_user_annotation` twin on the device's timeline), so that idle gaps
can be named by the program's phases.

The sites:

- `optim.make_train_step`'s step: span "step", its children
  "step.forward" (the loss), "step.backward" (`torch.autograd.grad`) and
  "step.optimizer" (`adamw_update`), and the mark "step.enqueued" once
  the step has enqueued its last op;
- `launch.serve.generate`: span "generate", its child "generate.prefill",
  and the mark "generate.enqueued" before any readback;
- `models.blocks.moe`: span "moe", and after `route` the MoE counters
  (`count_moe`): kept (token, slot) pairs, summed on the device with no
  host sync, and the valid pairs and the expert buffers' rows (E x G x
  C), which the shapes fix, counted on the host.

The shared clock: `enable` syncs the device once and records an anchor
event beside the host time; `records()` syncs and takes a second.  An
event's device time on the host clock is the first anchor's host time
plus the event's device time after it, scaled by the ratio of the two
anchors' host and device intervals; `records()["clock"]` gives the
device's drift against the host clock over that interval.  Without CUDA
every device time is None."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
from torch._subclasses.fake_tensor import is_fake

_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    """A span, or a mark (t0 == t1).  Device times (ns on the host clock,
    through the anchors) and `device_ms` (the span's end event less its
    start event, on the device's clock) are None without events."""
    kind: str
    name: str
    id: int
    parent: int | None
    attrs: dict
    host_t0_ns: int
    host_t1_ns: int | None = None
    device_t0_ns: float | None = None
    device_t1_ns: float | None = None
    device_ms: float | None = None


class _Tracer:
    def __init__(self):
        self.on = False
        self.clear()

    def clear(self):
        self.records: list[Record] = []
        self.events: list[list] = []     # [start, end] events of a record
        self.stack: list[int] = []       # ids of the open spans
        self.anchor = None               # (event, host ns) or None
        self.moe_kept: dict = {}         # device -> int64 kept pairs
        self.moe_pairs = 0
        self.moe_rows = 0


_T = _Tracer()


def enabled() -> bool:
    return _T.on


def enable() -> None:
    """Turns the tracer on (a no-op if it is on): with CUDA, syncs the
    device and records the first anchor."""
    if _T.on:
        return
    _T.clear()
    if torch.cuda.is_available():
        _T.anchor = _anchor()
    _T.on = True


def disable() -> None:
    _T.on = False
    _T.clear()


def reset() -> None:
    """Drops what was kept; the tracer stays as it was (a new first
    anchor if it is on)."""
    on = _T.on
    disable()
    if on:
        enable()


def _anchor():
    """(event, host ns): an event on an idle device, and the middle of the
    host times around its record and completion."""
    torch.cuda.synchronize()
    ev = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter_ns()
    ev.record()
    ev.synchronize()
    return ev, (t0 + time.perf_counter_ns()) // 2


def _event(tensor):
    """A timing event recorded on the current stream, where `tensor` is a
    real CUDA tensor and the clock has its anchor; else None."""
    if (_T.anchor is None or tensor is None or tensor.device.type != "cuda"
            or is_fake(tensor)):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "tensor", "attrs", "rec", "range")

    def __init__(self, name, tensor, attrs):
        self.name, self.tensor, self.attrs = name, tensor, attrs

    def __enter__(self):
        parent = _T.stack[-1] if _T.stack else None
        self.range = None
        if _profiling():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        self.rec = Record("span", self.name, len(_T.records), parent,
                          self.attrs, time.perf_counter_ns())
        _T.records.append(self.rec)
        _T.events.append([_event(self.tensor), None])
        _T.stack.append(self.rec.id)
        return self.rec

    def __exit__(self, *exc):
        rid = self.rec.id
        if rid < len(_T.records) and _T.records[rid] is self.rec:
            # (not dropped by a reset inside the span)
            self.rec.host_t1_ns = time.perf_counter_ns()
            _T.events[rid][1] = _event(self.tensor)
            _T.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, tensor: torch.Tensor | None = None, **attrs):
    """A span around a layer's work; `tensor` (any tensor of that work)
    says whether device events are recorded."""
    if not _T.on:
        return _NULL
    return _Span(name, tensor, attrs)


def mark(name: str, tensor: torch.Tensor | None = None, **attrs) -> None:
    """A point: the host's time now and, on CUDA, an event recorded after
    every op the host has enqueued on the current stream."""
    if not _T.on:
        return
    parent = _T.stack[-1] if _T.stack else None
    t = time.perf_counter_ns()
    rec = Record("mark", name, len(_T.records), parent, attrs, t, t)
    ev = _event(tensor)
    _T.records.append(rec)
    _T.events.append([ev, ev])


def count_moe(kept: torch.Tensor, pairs: int, rows: int) -> None:
    """Adds a MoE block's kept (token, slot) pairs (kept (G,S_g,K)) into a
    device tensor, with no host sync, and its valid pairs (B x S x K) and
    buffer rows (E x G x C), both fixed by the shapes, into host counts.
    Nothing on fake tensors or in a backward pass (remat's recomputed
    forward)."""
    if (not _T.on or is_fake(kept)
            or torch._C._current_graph_task_id() != -1):
        return
    acc = _T.moe_kept.get(kept.device)
    if acc is None:
        with torch.inference_mode(False):   # updated in and out of it
            acc = torch.zeros((), dtype=torch.int64, device=kept.device)
        _T.moe_kept[kept.device] = acc
    acc.add_(kept.sum())
    _T.moe_pairs += pairs
    _T.moe_rows += rows


def to_host_ns(elapsed_ms: float, first: tuple[float, int],
               second: tuple[float, int]) -> float:
    """Host ns of a device time `elapsed_ms` after the first anchor, given
    each anchor as (device ms after the first anchor, host ns): linear
    between the two."""
    (d0, h0), (d1, h1) = first, second
    return h0 + (elapsed_ms - d0) * (h1 - h0) / (d1 - d0)


def records() -> dict:
    """{"records": [Record], "clock": {...} or None}.  With events, syncs
    the device, takes the second anchor and fills each record's device
    times; "clock" gives the anchors' host interval in s and the device
    clock's drift against the host's over it (ns, and parts per
    million)."""
    out = [dataclasses.replace(r) for r in _T.records]
    if _T.anchor is None:
        return {"records": out, "clock": None}
    a0, h0 = _T.anchor
    a1, h1 = _anchor()
    d1 = a0.elapsed_time(a1)
    first, second = (0.0, h0), (d1, h1)
    for rec, (e0, e1) in zip(out, _T.events):
        if e0 is not None:
            rec.device_t0_ns = to_host_ns(a0.elapsed_time(e0), first, second)
        if e1 is not None:
            rec.device_t1_ns = to_host_ns(a0.elapsed_time(e1), first, second)
        if e0 is not None and e1 is not None and rec.kind == "span":
            rec.device_ms = e0.elapsed_time(e1)
    drift = (h1 - h0) - d1 * 1e6
    return {"records": out,
            "clock": {"interval_s": (h1 - h0) / 1e9, "drift_ns": drift,
                      "drift_ppm": 1e6 * drift / (h1 - h0)}}


def counters() -> dict:
    """Every count of the port in one dict: the MoE counters since the
    tracer was turned on (one device read) and the kernel wrappers' launch
    counts, read where they are kept, with the leaves AdamW's kernels
    updated (`adamw.leaves`)."""
    from repro_torch.kernels.adamw import adamw, global_norm
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.selective_scan import (selective_scan,
                                                    selective_scan_bwd)
    from repro_torch.kernels.wkv6 import wkv6, wkv6_bwd
    out = {"moe.valid_pairs": _T.moe_pairs,
           "moe.kept_pairs": sum(int(acc) for acc in _T.moe_kept.values()),
           "moe.buffer_rows": _T.moe_rows}
    for fn in (flash_attention, flash_attention_bwd, wkv6, wkv6_bwd,
               selective_scan, selective_scan_bwd, adamw, global_norm):
        out[f"{fn.__name__}.launches"] = fn.launches
        if hasattr(fn, "launches_mla"):
            out[f"{fn.__name__}.launches_mla"] = fn.launches_mla
    out["adamw.leaves"] = adamw.leaves
    return out
