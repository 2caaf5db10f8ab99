"""The port's cross-node DTCO analyses (`repro_torch.core.dtco`) and its
trace-driven cache simulator (`repro_torch.core.cachesim`) on the CPU.

DTCO: the iso-capacity and iso-area studies with `device="cpu"` against
the JAX reference's (`repro.core.dtco`) on the same workloads and nodes:
every row within 1e-12 relative, labels and capacities equal, both
headlines within 1e-12; then the contracts of `tests/test_dtco.py` on the
port (the scalar per-node path, the widening-gap trends, the per-node
baseline), and the default device raising without CUDA.

cachesim: a verbatim copy, held to the contracts of
`tests/test_cachesim.py` (hypothesis) and `tests/test_cachesim_exact.py`,
and to the reference module on the same seeded traces.

The reference's engines import `jax.experimental.enable_x64`, which JAX
0.9 no longer has; the `ref` fixture aliases it to `jax.enable_x64` when
it first runs, never at import.
"""

from __future__ import annotations

import dataclasses
import types

import hypothesis.strategies as st
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro_torch import scenarios
from repro_torch.core import cachesim, dtco, isoarea, sweep, traffic, tuner
from repro_torch.core.cachemodel import CacheModel
from repro_torch.core.cachesim import (SetAssocCache, misses_at_capacity,
                                       stack_distance_profile,
                                       trace_from_streams)
from repro_torch.core.isocap import INFER_BATCH, MEMS, TRAIN_BATCH
from repro_torch.core.tech import TECH_7NM, TECH_10NM, TECH_16NM
from repro_torch.core.traffic import INF, AccessStream, TrafficStats
from repro_torch.core.workloads import alexnet, paper_workloads

REL = 1e-12
BLOCK = 4096
ROW_FLOATS = ("feature_nm", "capacity_mb", "leakage_w", "area_mm2",
              "energy_x", "leak_x", "edp_x", "runtime_x")


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's modules, imported with the R1 alias."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.core import cachesim as rcachesim
    from repro.core import dtco as rdtco
    from repro.core import tech as rtech
    from repro.core import traffic as rtraffic
    from repro.core import workloads as rworkloads
    return types.SimpleNamespace(dtco=rdtco, cachesim=rcachesim, tech=rtech,
                                 traffic=rtraffic, workloads=rworkloads)


def _close(got: float, want: float) -> bool:
    return abs(got - want) <= REL * abs(want)


def _assert_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g.keys() == w.keys()
        assert (g["node"], g["mem"]) == (w["node"], w["mem"])
        for f in ROW_FLOATS:
            assert _close(g[f], w[f]), (g["node"], g["mem"], f, g[f], w[f])


def _assert_headline(got, want):
    assert got.keys() == want.keys()
    for mem in want:
        assert got[mem].keys() == want[mem].keys()
        for k, v in want[mem].items():
            assert _close(got[mem][k], v), (mem, k, got[mem][k], v)


# ---------------------------------------------------------------------------
# DTCO against the reference
# ---------------------------------------------------------------------------


def test_dtco_rows_and_headline_match_reference(ref):
    rows = dtco.analyze(device="cpu")
    want = ref.dtco.analyze()
    _assert_rows(rows, want)
    _assert_headline(dtco.headline(rows), ref.dtco.headline(want))
    head = dtco.headline(rows)
    # the trend the study exists to show (16 -> 7 nm)
    assert head["sram"]["leak_w_first"] == pytest.approx(6.442749, rel=1e-6)
    assert head["sram"]["leak_w_last"] == pytest.approx(13.368079, rel=1e-6)
    assert head["stt"]["edp_reduction_last"] \
        > head["stt"]["edp_reduction_first"]


def test_dtco_isoarea_rows_and_headline_match_reference(ref):
    rows = dtco.isoarea_analyze(device="cpu")
    want = ref.dtco.isoarea_analyze()
    _assert_rows(rows, want)
    head = dtco.isoarea_headline(rows)
    _assert_headline(head, ref.dtco.isoarea_headline(want))
    assert (head["stt"]["capacity_mb_first"], head["stt"]["capacity_mb_last"],
            head["sot"]["capacity_mb_first"], head["sot"]["capacity_mb_last"]) \
        == (7, 7, 10, 9)


def test_dtco_specs_match_reference(ref):
    """The two studies' specs: the same designs (node, mem, capacity,
    normalization group) and scenarios as the reference's."""
    for name in ("spec", "isoarea_spec"):
        kw = {"device": "cpu"} if name == "isoarea_spec" else {}
        got = getattr(dtco, name)(**kw)
        want = getattr(ref.dtco, name)()
        assert [(p.node.name, p.mem, p.capacity_bytes, p.group)
                for p in got.designs] \
            == [(p.node.name, p.mem, p.capacity_bytes, p.group)
                for p in want.designs]
        assert [scenarios.name_of(s) for s in got.scenarios] \
            == [scenarios.name_of(s) for s in want.scenarios]


def test_dtco_small_node_set_matches_reference(ref):
    """Two workloads, two nodes (the contracts' small study) on both."""
    got = dtco.analyze(workloads=dict(list(paper_workloads().items())[:2]),
                       nodes=(TECH_16NM, TECH_7NM), device="cpu")
    want = ref.dtco.analyze(
        workloads=dict(list(ref.workloads.paper_workloads().items())[:2]),
        nodes=(ref.tech.TECH_16NM, ref.tech.TECH_7NM))
    _assert_rows(got, want)


# ---------------------------------------------------------------------------
# tests/test_dtco.py's contracts, on the port
# ---------------------------------------------------------------------------


STAGES = ((False, INFER_BATCH), (True, TRAIN_BATCH))


@pytest.fixture(scope="module")
def small_dtco():
    workloads = dict(list(paper_workloads().items())[:2])
    nodes = (TECH_16NM, TECH_7NM)
    return workloads, nodes, dtco.analyze(workloads=workloads, nodes=nodes,
                                          device="cpu")


@pytest.fixture(scope="module")
def small_isoarea():
    workloads = dict(list(paper_workloads().items())[:2])
    nodes = (TECH_16NM, TECH_7NM)
    return workloads, nodes, dtco.isoarea_analyze(
        workloads=workloads, nodes=nodes, device="cpu")


def _scalar_means(workloads, designs):
    reps = {(n, m, t): traffic.energy(traffic.build(w, b, t), designs[m])
            for n, w in workloads.items()
            for t, b in STAGES for m in MEMS}

    def mean(fn, mem):
        vals = [fn(reps[n, mem, t]) / fn(reps[n, "sram", t])
                for n in workloads for t, _ in STAGES]
        return sum(vals) / len(vals)
    return mean


def test_dtco_rows_match_scalar_per_node_path(small_dtco):
    """Every DTCO cell equals the scalar study: a per-node CacheModel tune
    plus a per-(workload, stage) traffic.energy fold."""
    workloads, nodes, rows = small_dtco
    it = iter(rows)
    for node in nodes:
        designs = {m: tuner.tune_loop(CacheModel(m, node=node, device="cpu"),
                                      3 * 2**20) for m in MEMS}
        mean = _scalar_means(workloads, designs)
        for mem in MEMS:
            row = next(it)
            assert (row.node, row.mem) == (node.name, mem)
            assert row.leakage_w == pytest.approx(designs[mem].leakage_w,
                                                  rel=REL)
            assert row.area_mm2 == pytest.approx(designs[mem].area_mm2,
                                                 rel=REL)
            assert row.energy_x == pytest.approx(
                mean(lambda r: r.total_j(False), mem), rel=REL)
            assert row.leak_x == pytest.approx(
                mean(lambda r: r.leak_j, mem), rel=REL)
            assert row.edp_x == pytest.approx(
                mean(lambda r: r.edp(True), mem), rel=REL)
            assert row.runtime_x == pytest.approx(
                mean(lambda r: r.runtime_s, mem), rel=REL)
    assert next(it, None) is None


def test_isoarea_rows_match_scalar_per_node_path(small_isoarea):
    workloads, nodes, rows = small_isoarea
    it = iter(rows)
    for node in nodes:
        corners = isoarea.corners(3.0, node=node, device="cpu")
        designs = {p.mem: tuner.tune_loop(
                       CacheModel(p.mem, node=node, device="cpu"),
                       p.capacity_bytes)
                   for p in corners}
        mean = _scalar_means(workloads, designs)
        for p in corners:
            row = next(it)
            assert (row.node, row.mem) == (node.name, p.mem)
            assert row.capacity_mb == p.capacity_bytes / 2**20
            assert row.leakage_w == pytest.approx(designs[p.mem].leakage_w,
                                                  rel=REL)
            assert row.area_mm2 == pytest.approx(designs[p.mem].area_mm2,
                                                 rel=REL)
            assert row.energy_x == pytest.approx(
                mean(lambda r: r.total_j(False), p.mem), rel=REL)
            assert row.leak_x == pytest.approx(
                mean(lambda r: r.leak_j, p.mem), rel=REL)
            assert row.edp_x == pytest.approx(
                mean(lambda r: r.edp(True), p.mem), rel=REL)
    assert next(it, None) is None


def test_dtco_trend_sram_leakage_blowup():
    rows = dtco.analyze(workloads=dict(list(paper_workloads().items())[:1]),
                        device="cpu")
    by = {(r.node, r.mem): r for r in rows}
    names = [n.name for n in dtco.NODES]
    sram_w = [by[n, "sram"].leakage_w for n in names]
    assert sram_w == sorted(sram_w), "SRAM leakage must grow 16nm -> 7nm"
    for mem in ("stt", "sot"):
        gap = [1.0 / by[n, mem].leak_x for n in names]
        assert gap == sorted(gap), f"{mem} leakage gap must widen"
        edp_red = [1.0 / by[n, mem].edp_x for n in names]
        assert edp_red[-1] > edp_red[0], f"{mem} EDP gap must widen"


def test_isoarea_trends_across_nodes():
    rows = dtco.isoarea_analyze(
        workloads=dict(list(paper_workloads().items())[:1]), device="cpu")
    by = {(r.node, r.mem): r for r in rows}
    names = [n.name for n in dtco.NODES]
    sram_w = [by[n, "sram"].leakage_w for n in names]
    assert sram_w == sorted(sram_w) and sram_w[-1] > sram_w[0]
    for mem in ("stt", "sot"):
        caps = [by[n, mem].capacity_mb for n in names]
        assert all(c > by[names[0], "sram"].capacity_mb for c in caps), mem
        assert caps == sorted(caps, reverse=True), mem
        edp = [by[n, mem].edp_x for n in names]
        assert edp == sorted(edp, reverse=True), mem
        leak = [by[n, mem].leak_x for n in names]
        assert leak == sorted(leak, reverse=True), mem


@pytest.mark.parametrize("study", ["small_dtco", "small_isoarea"])
def test_each_node_is_its_own_baseline(study, request):
    _, _, rows = request.getfixturevalue(study)
    for r in rows:
        if r.mem == "sram":
            for f in ("energy_x", "leak_x", "edp_x", "runtime_x"):
                assert getattr(r, f) == pytest.approx(1.0, rel=REL)


def test_lm_sweep_spec_node_axis():
    spec = scenarios.lm_sweep_spec(archs=("tinyllama-1.1b",),
                                   shapes=("decode_32k",),
                                   nodes=(TECH_16NM, TECH_10NM),
                                   name="lm-dtco-test")
    assert len(spec.designs) == 2 * len(sweep.MEMS)
    assert {p.node.name for p in spec.designs} == \
        {TECH_16NM.name, TECH_10NM.name}


DEFAULT_DEVICE_CALLS = {
    "dtco.analyze": lambda: dtco.analyze(
        workloads=dict(list(paper_workloads().items())[:1])),
    "dtco.isoarea_analyze": lambda: dtco.isoarea_analyze(
        workloads=dict(list(paper_workloads().items())[:1])),
    "dtco.isoarea_spec": lambda: dtco.isoarea_spec(),
}


@pytest.mark.parametrize("entry", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry]()


# ---------------------------------------------------------------------------
# cachesim: tests/test_cachesim.py's properties (hypothesis)
# ---------------------------------------------------------------------------

traces = st.lists(st.integers(0, 40), min_size=1, max_size=300)
streams = st.lists(
    st.tuples(st.floats(1.0, 1e9), st.booleans(),
              st.one_of(st.just(INF), st.floats(1.0, 1e8))),
    min_size=1, max_size=20)
lowerable = st.lists(
    st.tuples(st.floats(4096.0, 4096.0 * 48), st.booleans(),
              st.one_of(st.just(INF), st.floats(4096.0, 4096.0 * 128))),
    min_size=1, max_size=8)


@given(traces)
@settings(max_examples=50, deadline=None)
def test_stack_distance_matches_fully_assoc_lru(trace):
    dist = stack_distance_profile(trace)
    for cap in (1, 2, 4, 8, 64):
        sim = SetAssocCache(cap, assoc=cap)
        for b in trace:
            sim.access(b)
        assert sim.stats.misses == misses_at_capacity(dist, cap)


@given(traces)
@settings(max_examples=30, deadline=None)
def test_miss_curve_monotone_in_capacity(trace):
    dist = stack_distance_profile(trace)
    misses = [misses_at_capacity(dist, c) for c in (1, 2, 4, 8, 16, 64)]
    assert all(a >= b for a, b in zip(misses, misses[1:]))
    assert misses[0] <= len(trace)
    assert misses[-1] >= len(set(trace))


@given(traces, st.integers(1, 4))
@settings(max_examples=30, deadline=None)
def test_set_assoc_writebacks_bounded(trace, assoc):
    sim = SetAssocCache(8, assoc=assoc)
    n_writes = 0
    for i, b in enumerate(trace):
        is_write = (i % 3 == 0)
        n_writes += is_write
        sim.access(b, is_write)
    assert sim.stats.writebacks <= n_writes
    assert sim.stats.misses <= sim.stats.accesses


@given(streams)
@settings(max_examples=50, deadline=None)
def test_dram_traffic_monotone_in_capacity(spec):
    stats = TrafficStats(
        "prop", 1, False,
        tuple(AccessStream(f"s{i}", b, w, rd)
              for i, (b, w, rd) in enumerate(spec)), 1e9)
    tx = [stats.dram_tx(2**20 * c) for c in (1, 2, 4, 8, 32, 128)]
    assert all(a >= b - 1e-6 for a, b in zip(tx, tx[1:]))
    assert tx[-1] >= 0.0
    assert tx[0] <= stats.l2_read_tx + stats.l2_write_tx + 1e-6


@given(lowerable)
@settings(max_examples=30, deadline=None)
def test_lowered_trace_miss_curve_monotone(spec):
    strs = [AccessStream(f"s{i}", b, w, rd)
            for i, (b, w, rd) in enumerate(spec)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    dist = stack_distance_profile([b for b, _ in trace])
    misses = [misses_at_capacity(dist, c)
              for c in (1, 2, 4, 8, 16, 64, 1 << 20)]
    assert all(a >= b for a, b in zip(misses, misses[1:]))
    unique = len({b for b, _ in trace})
    assert misses[-1] == unique
    if any(rd != INF for _, _, rd in spec):
        assert misses[-1] < len(trace)


@given(streams)
@settings(max_examples=50, deadline=None)
def test_streaming_accesses_always_miss(spec):
    stats = TrafficStats(
        "prop", 1, False,
        tuple(AccessStream(f"s{i}", b, w, INF)
              for i, (b, w, _) in enumerate(spec)), 1e9)
    total = stats.l2_read_tx + stats.l2_write_tx
    assert abs(stats.dram_tx(1 << 40) - total) < 1e-6


# ---------------------------------------------------------------------------
# cachesim: tests/test_cachesim_exact.py's regressions
# ---------------------------------------------------------------------------


def test_finite_reuse_distance_produces_hits():
    strs = [AccessStream("reused", 16 * BLOCK, False, 8 * BLOCK),
            AccessStream("streaming", 16 * BLOCK, True, INF)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    unique = len({b for b, _ in trace})
    assert len(trace) == unique + 16
    dist = stack_distance_profile([b for b, _ in trace])
    assert misses_at_capacity(dist, 1 << 20) == unique < len(trace)
    assert misses_at_capacity(dist, 2) == len(trace)


def test_reuse_hit_threshold_tracks_reuse_distance():
    strs = [AccessStream("s", 32 * BLOCK, False, 8 * BLOCK)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    dist = stack_distance_profile([b for b, _ in trace])
    assert misses_at_capacity(dist, 32) < misses_at_capacity(dist, 2)


def test_streaming_trace_stays_cold():
    strs = [AccessStream("a", 8 * BLOCK, False, INF),
            AccessStream("b", 8 * BLOCK, True, INF)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    assert len(trace) == 16 == len({b for b, _ in trace})


def test_trace_cross_validates_analytic_model_direction():
    stats = traffic.build(alexnet(), batch=1, training=False)
    trace = trace_from_streams(stats.streams, block_bytes=BLOCK,
                               max_blocks_per_stream=64)
    dist = stack_distance_profile([b for b, _ in trace])
    caps_blocks = (64, 256, 1024, 4096)
    sim = [misses_at_capacity(dist, c) for c in caps_blocks]
    analytic = [stats.dram_tx(c * BLOCK) for c in caps_blocks]
    assert all(a >= b for a, b in zip(sim, sim[1:]))
    assert all(a >= b for a, b in zip(analytic, analytic[1:]))
    assert sim[-1] < sim[0]
    assert analytic[-1] < analytic[0]


def test_misses_monotone_non_increasing_in_capacity():
    strs = [AccessStream(f"s{i}", (4 + 8 * i) * BLOCK, i % 2 == 0,
                         INF if i % 3 == 0 else (2 << i) * BLOCK)
            for i in range(6)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    dist = stack_distance_profile([b for b, _ in trace])
    misses = [misses_at_capacity(dist, c)
              for c in (1, 2, 4, 8, 16, 64, 256, 1 << 16)]
    assert all(a >= b for a, b in zip(misses, misses[1:]))
    assert misses[-1] == len({b for b, _ in trace})


def test_stack_distance_matches_exact_sim_on_retouch_trace():
    strs = [AccessStream("r", 12 * BLOCK, False, 4 * BLOCK),
            AccessStream("w", 6 * BLOCK, True, 2 * BLOCK)]
    trace = trace_from_streams(strs, block_bytes=BLOCK)
    dist = stack_distance_profile([b for b, _ in trace])
    for cap in (2, 4, 8, 32):
        sim = SetAssocCache(cap, assoc=cap)
        for b, w in trace:
            sim.access(b, w)
        assert sim.stats.misses == misses_at_capacity(dist, cap)


@pytest.mark.parametrize("capacity,assoc", [(0, 16), (-3, 16), (4, 0),
                                            (4, -1)])
def test_degenerate_geometry_rejected(capacity, assoc):
    with pytest.raises(ValueError):
        SetAssocCache(capacity, assoc)


def test_capacity_below_assoc_keeps_full_capacity():
    sim = SetAssocCache(5, assoc=16)
    assert sim.n_sets == 1 and sim.assoc == 5
    for b in range(5):
        sim.access(b)
    for b in range(5):
        assert sim.access(b)
    assert sim.stats.misses == 5


def test_no_zero_byte_streams_in_build_output():
    stats = traffic.build(alexnet(), batch=4, training=True)
    assert all(s.bytes_total > 0 for s in stats.streams)
    labels = {s.label for s in stats.streams}
    assert "fc6.bw.w+" not in labels
    assert "fc6.bw.w" in labels


def test_cachesim_matches_reference_on_seeded_traces(ref):
    """The same seeded traces and lowered streams through both modules:
    equal profiles, miss counts and simulator statistics."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        trace = rng.integers(0, 64, size=400).tolist()
        writes = (rng.random(400) < 0.3).tolist()
        assert cachesim.stack_distance_profile(trace) \
            == ref.cachesim.stack_distance_profile(trace)
        for cap, assoc in ((8, 2), (16, 4), (32, 32)):
            mine = cachesim.SetAssocCache(cap, assoc)
            theirs = ref.cachesim.SetAssocCache(cap, assoc)
            for b, w in zip(trace, writes):
                assert mine.access(b, w) == theirs.access(b, w)
            assert dataclasses.asdict(mine.stats) \
                == dataclasses.asdict(theirs.stats)
    stats = traffic.build(alexnet(), batch=1, training=True)
    rstats = ref.traffic.build(ref.workloads.alexnet(), batch=1,
                               training=True)
    assert cachesim.trace_from_streams(stats.streams, BLOCK, 32) \
        == ref.cachesim.trace_from_streams(rstats.streams, BLOCK, 32)
