"""The profile's reduction on synthetic profiles: the idle share as a union
of intervals, span attribution, and the sequence-number join of backward
nodes to the forward ops that recorded them."""

import pytest

from portbench import flops, trace
from portbench.metrics import _common
from portbench.trace import Ev


def test_union_merges_overlaps_and_clips():
    got = trace.union([(5, 10), (0, 3), (8, 12), (2, 4), (20, 30)], 1, 25)
    assert got == [(1, 4), (5, 12), (20, 25)]


def test_idle_share_counts_overlapping_kernels_once():
    dev = [(0, 40, "a"), (10, 50, "b"), (70, 90, "c")]   # two streams
    red = trace.reduce([Ev("pb:stretch", 0, 100)], dev, (0, 100))
    assert red.busy_us == 70
    assert red.idle_share == pytest.approx(0.30)
    assert dict(red.device_ops) == {"a": 40, "b": 40, "c": 20}
    assert red.busy_between(45, 80) == 15


def test_idle_gaps_are_named_by_the_host_activity():
    host = Ev("pb:stretch", 0, 100, children=[
        Ev("pb:serve.batch#0", 0, 40, children=[Ev("aten::mm", 1, 5)]),
        Ev("wait", 40, 100)])
    dev = [(25, 30, "k"), (32, 40, "k"), (90, 100, "k")]
    red = trace.reduce([host], dev, (0, 100))
    gaps = dict(red.idle_gaps)
    assert gaps == {"wait": 50, "pb:serve.batch": 25,
                    "(idle gaps under 20 us)": 2}


def test_idle_time_under_a_wait_for_an_arrival_is_the_waits():
    """The host reads a batch's token (a copy that ends the device's work
    and returns after it), then waits for the next arrival."""
    host = Ev("pb:stretch", 0, 200, children=[
        Ev("pb:serve.batch#0", 0, 50, children=[
            Ev("cudaMemcpyAsync", 10, 48)]),
        Ev(trace.WAIT, 60, 150),
        Ev("pb:serve.batch#1", 150, 200)])
    dev = [(0, 45, "k"), (150, 200, "k")]
    red = trace.reduce([host], dev, (0, 200))
    assert dict(red.idle_gaps) == {trace.WAIT: 90, "cudaMemcpyAsync": 15}


def _step(fwd_thread=1):
    """A forward span (op seq 5 on thread 1, 10 us of kernels), its
    backward node (seq 5, 30 us) holding a recomputed span (7 us), another
    node (seq 6, 100 us) and a node of seq 5 recorded on another thread."""
    fwd = Ev("pb:unembed#0", 0, 10, thread=1, children=[
        Ev("aten::mm", 1, 9, thread=1, seq=5, kernel_us=10.0)])
    other = Ev("aten::add", 11, 12, thread=1, seq=6, kernel_us=1.0)
    bwd = Ev(trace.BACKWARD + ": MmBackward0", 20, 60, thread=2, seq=5,
             fwd_thread=fwd_thread, children=[
                 Ev("MmBackward0", 21, 59, thread=2, seq=5, fwd_thread=1,
                    kernel_us=30.0, children=[
                        Ev("pb:unembed#1", 30, 40, thread=2, children=[
                            Ev("aten::mm", 31, 39, thread=2, seq=9,
                               kernel_us=7.0)])])])
    bwd2 = Ev(trace.BACKWARD + ": AddBackward0", 61, 70, thread=2, seq=6,
              fwd_thread=1, kernel_us=100.0)
    alien = Ev(trace.BACKWARD + ": MmBackward0", 71, 80, thread=2, seq=5,
               fwd_thread=3, kernel_us=1000.0)
    return [fwd, other, bwd, bwd2, alien]


def test_backward_joins_by_sequence_number_and_forward_thread():
    red = trace.reduce(_step(), [], (0, 100))
    spans = red.forward("unembed")
    assert [(s.index, s.device_us, s.in_backward) for s in spans] == [
        (0, 10.0, False), (1, 7.0, True)]
    assert red.backward_us["unembed"] == 30.0
    assert red.backward_joined["unembed"] == 1
    assert [s.backward_us for s in spans] == [30.0, 0.0]


def test_no_join_where_the_forward_thread_differs():
    red = trace.reduce(_step(fwd_thread=4), [], (0, 100))
    assert "unembed" not in red.backward_us
    assert red.backward_joined.get("unembed", 0) == 0


def test_span_annotations_are_not_device_work():
    assert trace._annotation("pb:adamw_update#2")
    assert not trace._annotation("flash_fwd_bf16<64>")


def _attention_ctx(fwd_us, bwd_us):
    """Spans of ops.attention calls at MiniCPM-2B's training shape, each
    with the forward and joined backward device us given."""
    q = {"shape": (4, 2048, 36, 64), "dtype": "bfloat16", "grad": True}
    call = {"args": [q, q, q], "kwargs": {}}
    spans = [trace.SpanTime("attention", i, 1, f, False, set(), 0.0, 0.0, b)
             for i, (f, b) in enumerate(zip(fwd_us, bwd_us))]
    red = trace.Reduced(1.0, 1.0, spans, {}, {}, [], [])
    return {"reduced": red, "calls": {"attention": [call] * len(spans)}}


def test_a_call_the_profiler_tied_no_time_to_is_left_out_of_both_sums():
    fwd_s = flops.roofline_s(
        flops.attention_flops(4, 2048, 2048, 36, 64, True),
        flops.attention_bytes(4, 2048, 2048, 36, 64, 2, lse=True))
    bwd_s = flops.roofline_s(
        flops.attention_bwd_flops(4, 2048, 2048, 36, 64, True),
        flops.attention_bwd_bytes(4, 2048, 2048, 36, 64, 2))
    whole = _attention_ctx([250.0, 250.0], [800.0, 800.0])
    holed = _attention_ctx([250.0, 0.0, 250.0], [800.0, 0.0, 800.0])
    for ctx in (whole, holed):
        assert _common.flash_fwd_roofline_pct(ctx) == pytest.approx(
            100 * fwd_s / 250e-6)
        assert _common.flash_bwd_roofline_pct(ctx) == pytest.approx(
            100 * bwd_s / 800e-6)
    none = _attention_ctx([0.0], [0.0])
    assert _common.flash_fwd_roofline_pct(none) is None
    assert _common.flash_bwd_roofline_pct(none) is None
