"""Arithmetic the metric readers share.  A reader is `metrics/<metric>.py`
with `read(ctx) -> float | None` (None: nothing to read, the metric is
left out) and, where it needs spans, `SPANS`.  `ctx` holds "run" (the
harness's Run), "reduced" (trace.Reduced of the traced stretch), "calls"
(each span label's calls' arguments), "host_enqueue_s" (host seconds of
each step or batch call outside the stretch), "stretch_flops" (model
FLOPs of the stretch's work) and "stretch_steps" or "stretch_batches"."""

from __future__ import annotations

import statistics

from portbench import flops

ATTENTION = {"attention": "repro_torch.kernels.ops:attention"}


def host_ms(ctx) -> float | None:
    xs = ctx["host_enqueue_s"]
    return 1e3 * statistics.median(xs) if xs else None


def mfu_pct(ctx) -> float | None:
    red = ctx["reduced"]
    if not ctx["stretch_flops"] or red.window_us <= 0:
        return None
    return 100.0 * ctx["stretch_flops"] / (red.window_us * 1e-6) \
        / flops.PEAK_BF16_FLOPS


def idle_pct(ctx) -> float | None:
    red = ctx["reduced"]
    if red.window_us <= 0 or red.busy_us <= 0:
        return None
    return 100.0 * red.idle_share


def service(ctx) -> tuple[float, float]:
    """(device-busy us, us) summed over the serve.batch spans: each batch
    from its generate call to its token on the host, waits for arrivals
    left out."""
    red = ctx["reduced"]
    spans = [s for s in red.spans if s.label == "serve.batch"]
    return (sum(red.busy_between(s.t0, s.t1) for s in spans),
            sum(s.t1 - s.t0 for s in spans))


def mfu_serve_pct(ctx) -> float | None:
    _, us = service(ctx)
    if not ctx["stretch_flops"] or us <= 0:
        return None
    return 100.0 * ctx["stretch_flops"] / (us * 1e-6) / flops.PEAK_BF16_FLOPS


def idle_serve_pct(ctx) -> float | None:
    busy, us = service(ctx)
    return 100.0 * (1.0 - busy / us) if busy > 0 and us > 0 else None


def forward_ms(ctx, labels, per: str) -> float | None:
    """Device ms of the labels' forward spans (recomputed ones included)
    per step or batch of the stretch."""
    red = ctx["reduced"]
    us = sum(s.device_us for s in red.spans if s.label in labels)
    n = ctx.get(per)
    return us / 1e3 / n if us > 0 and n else None


def _attn_shape(call):
    q, k = call["args"][0], call["args"][1]
    b, sq, h, hd = q["shape"]
    skv = k["shape"][1]
    kw = call["kwargs"]
    causal = kw.get("causal", True)
    elsize = 2 if q["dtype"] == "bfloat16" else 4
    window = kw.get("window")
    return b, sq, skv, h, hd, causal, elsize, window, q["grad"]


def flash_fwd_roofline_pct(ctx) -> float | None:
    """Sum of the calls' roofline times over their device time: each
    forward span of ops.attention, recomputed ones included.  A span to
    which the profiler tied no device time (it drops the link of a kernel
    now and then) is left out of both sums: a call's bound counts only
    with its time."""
    red, calls = ctx["reduced"], ctx["calls"].get("attention", [])
    bound = dev = 0.0
    for s in red.forward("attention"):
        b, sq, skv, h, hd, causal, el, window, grad = _attn_shape(
            calls[s.index])
        if window is not None:
            return None   # a windowed count is not frozen here
        if s.device_us <= 0:
            continue
        bound += flops.roofline_s(
            flops.attention_flops(b, sq, skv, h, hd, causal),
            flops.attention_bytes(b, sq, skv, h, hd, el, lse=grad))
        dev += s.device_us * 1e-6
    return 100.0 * bound / dev if dev > 0 else None


def flash_bwd_roofline_pct(ctx) -> float | None:
    """The backward of every forward (not recomputed) ops.attention call
    that needed a gradient, joined by sequence number, each call's bound
    with its own joined time (a call with none joined is left out)."""
    red, calls = ctx["reduced"], ctx["calls"].get("attention", [])
    bound = dev = 0.0
    for s in red.forward("attention"):
        if s.in_backward:
            continue
        b, sq, skv, h, hd, causal, el, window, grad = _attn_shape(
            calls[s.index])
        if window is not None:
            return None
        if grad and s.backward_us > 0:
            bound += flops.roofline_s(
                flops.attention_bwd_flops(b, sq, skv, h, hd, causal),
                flops.attention_bwd_bytes(b, sq, skv, h, hd, el))
            dev += s.backward_us * 1e-6
    return 100.0 * bound / dev if dev > 0 else None
