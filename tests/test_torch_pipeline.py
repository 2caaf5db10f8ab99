"""The port's float64 DeepNVM++ pipeline (`repro_torch.core`,
`repro_torch.scenarios`) against the JAX reference on the CPU.

Both sides get the same inputs: the same specs, workloads, nodes and
capacities.  The port runs with `device="cpu"`.  Bar: every float64 output
within 1e-12 relative of the reference (the bar the reference holds
between its own scalar and batched paths), and tuned organization indices
equal.  A near-tie in Algorithm 1 that flips shows as an unequal index.

The reference's engines import `jax.experimental.enable_x64`, which JAX
0.9 no longer has; `jax.enable_x64` is the same context manager.  The
`ref` fixture sets that alias when the first test that needs the
reference runs, never at import, so it cannot change how other test files
collect.

The copied modules are pinned to their reference source, modulo the
`repro.` -> `repro_torch.` import rewrite: the plain copies as text, the
ones that carry a `device` argument (or are rewritten in torch) function
by function, with the functions that differ listed.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import scenarios as t_scn
from repro_torch.core import (cachemodel, calibration, engine, isoarea,
                              isocap, scaling, sweep, tech, traffic, tuner,
                              workload_engine, workloads)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
REL = 1e-12
MEMS = ("sram", "stt", "sot")
CAPS_MB = (0.5, 1, 3, 7, 10, 16, 64)
GOLDEN_SPECS = ("isocap", "dtco", "dtco_isoarea", "lm_nvm", "mixed_cnn_lm")
PPA_FIELDS = ("read_latency_s", "write_latency_s", "read_energy_j",
              "write_energy_j", "leakage_w", "area_mm2")
FOLD_FIELDS = ("l2_read_tx", "l2_write_tx", "dram_tx", "runtime_s",
               "runtime_nodram_s", "dyn_read_j", "dyn_write_j", "leak_j",
               "leak_nodram_j", "dram_j")
STAGES = ((False, 4), (True, 64))


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's pipeline modules, imported with the R1 alias."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro import scenarios
    from repro.core import (engine, isoarea, isocap, scaling, sweep, tech,
                            tuner, workload_engine, workloads)
    return types.SimpleNamespace(
        engine=engine, isoarea=isoarea, isocap=isocap, scaling=scaling,
        sweep=sweep, tech=tech, tuner=tuner, workload_engine=workload_engine,
        workloads=workloads, scenarios=scenarios)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-300)))


def _assert_same(got, want, where=""):
    """Nested dicts / lists / tuples of floats within REL; the rest equal."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= REL * abs(want), (where, got, want)
    else:
        assert got == want, (where, got, want)


# ---------------------------------------------------------------------------
# The copies, pinned to the reference source
# ---------------------------------------------------------------------------


def _rewrite(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text).replace(
        "from repro import", "from repro_torch import")


PLAIN_COPIES = ("core/tech.py", "core/mtj.py", "core/bitcell.py",
                "core/workloads.py", "core/traffic.py", "core/dse.py",
                "core/report.py", "core/cachesim.py", "scenarios.py",
                "launch/flops.py", "sweep/client.py", "inverse/bounds.py",
                "inverse/problem.py")


@pytest.mark.parametrize("module", PLAIN_COPIES)
def test_plain_copies_are_verbatim(module):
    assert ((SRC / "repro_torch" / module).read_text()
            == _rewrite((SRC / "repro" / module).read_text()))


# Top-level names (functions, classes, Class.method, assigned names) whose
# code differs from the reference's; every other one is the same code
# after the import rewrite (docstrings and comments aside).
DIFFERS = {
    "core/cachemodel.py": {"CacheModel.__init__",
                           "CacheModel.evaluate_batch"},
    "core/calibration.py": {"_get_cached", "get"},
    "core/tuner.py": {"tune", "_tuned_design_cached", "tuned_design",
                      "iso_area_capacity", "table2"},
    "core/engine.py": {"_PERI_16NM_ROW", "_ppa_kernel", "_tech_matrices",
                       "_run_kernel", "evaluate", "sweep",
                       "_design_table_cached", "design_table", "warmup"},
    "core/workload_engine.py": {
        "_miss_tx", "_miss_tx_kernel", "_fold", "_fold_kernel", "_run_fold", "_tables_from", "_evaluate_cached", "evaluate",
        "evaluate_platforms", "evaluate_chunk", "_sharded_fold",
        "evaluate_chunk_group", "evaluate_bucketed", "warmup_fold",
        "warmup", "dram_tx"},
    "core/sweep.py": {"SweepSpec.run", "SymbolicSweepSpec.run",
                      "lower_designs", "_run_cached", "run", "_chunk_result",
                      "iter_shards", "run_sharded", "merge_results",
                      "SweepResult.merge"},
    "core/isocap.py": {"designs_at", "analyze", "batch_sweep"},
    "core/isoarea.py": {"corners", "designs", "dram_reduction_curve",
                        "analyze"},
    "core/scaling.py": {"tuned_table", "ppa_sweep", "workload_sweep"},
    "core/dtco.py": {"analyze", "_rows", "isoarea_spec", "isoarea_analyze"},
    "sweep/service.py": {"evaluate_spec", "SweepService.__init__",
                         "SweepService._result_for", "SweepService.warmup",
                         "enable_compilation_cache", "SweepHTTPServer"},
    "sweep/__init__.py": set(),
    "sweep/__main__.py": set(),
    "sweep_cli.py": {"_add_shard_flags", "_add_device_flag", "_run_spec",
                     "cmd_run", "cmd_mega", "cmd_invert", "_default_service",
                     "_default_services", "_service", "answer", "serve",
                     "cmd_serve", "main"},
}


def _strip_docstring(node):
    body = getattr(node, "body", None)
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        node.body = body[1:] or [ast.Pass()]
    return node


def _units(text: str) -> dict[str, str]:
    """name -> normalized code of every top-level statement but imports
    and the module docstring; a class also yields one unit per method."""
    units = {}
    for node in ast.parse(text).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
            if isinstance(node, ast.ClassDef):
                methods = [m for m in node.body
                           if isinstance(m, ast.FunctionDef)]
                for m in methods:
                    units[f"{name}.{m.name}"] = ast.unparse(
                        _strip_docstring(m))
                node.body = [m for m in node.body if m not in methods]
            units[name] = ast.unparse(_strip_docstring(node))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            units[" ".join(ast.unparse(t) for t in targets)] = \
                ast.unparse(node)
        else:
            units[ast.unparse(node)[:60]] = ast.unparse(node)
    return units


@pytest.mark.parametrize("module", sorted(DIFFERS))
def test_ported_modules_differ_only_where_listed(module):
    mine = _units((SRC / "repro_torch" / module).read_text())
    theirs = _units(_rewrite((SRC / "repro" / module).read_text()))
    listed = DIFFERS[module]
    for name in (mine.keys() | theirs.keys()) - listed:
        assert name in mine and name in theirs, f"{module}: {name}"
        assert mine[name] == theirs[name], f"{module}: {name} differs"
    for name in listed:   # the list names only what really differs
        assert mine.get(name) != theirs.get(name), f"{module}: {name}"


def test_port_imports_no_jax_and_nothing_of_repro():
    for path in [*(SRC / "repro_torch" / "core").glob("*.py"),
                 *(SRC / "repro_torch" / "sweep").glob("*.py"),
                 *(SRC / "repro_torch" / "inverse").glob("*.py"),
                 SRC / "repro_torch" / "sweep_cli.py",
                 SRC / "repro_torch" / "scenarios.py",
                 SRC / "repro_torch" / "obs.py",
                 *(SRC / "repro_torch" / "launch").glob("*.py"),
                 *(SRC / "repro_torch" / "distributed").glob("*.py"),
                 *(SRC / "repro_torch" / "models").glob("*.py"),
                 *(SRC / "repro_torch" / "kernels").glob("*.py"),
                 *(ROOT / "examples").glob("torch_*.py"),
                 *(ROOT / "tools").glob("*.py"),
                 ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), \
                    f"{path.name} imports {n}"


# ---------------------------------------------------------------------------
# Circuit engine
# ---------------------------------------------------------------------------


def _caps_bytes():
    return tuple(int(c * 2**20) for c in CAPS_MB)


@pytest.mark.parametrize("node_name", list(tech.NODES))
def test_design_table_matches_reference(ref, node_name):
    node, rnode = tech.NODES[node_name], ref.tech.NODES[node_name]
    got = engine.design_table(MEMS, _caps_bytes(), nodes=node, device="cpu")
    want = ref.engine.design_table(MEMS, _caps_bytes(), nodes=rnode)
    for f in PPA_FIELDS:
        assert _rel(getattr(got, f), getattr(want, f)) <= REL, f
    np.testing.assert_array_equal(got.valid, want.valid)


@pytest.mark.parametrize("node_name", list(tech.NODES))
def test_tuned_index_matches_reference(ref, node_name):
    node, rnode = tech.NODES[node_name], ref.tech.NODES[node_name]
    got = engine.design_table(MEMS, _caps_bytes(), nodes=node, device="cpu")
    want = ref.engine.design_table(MEMS, _caps_bytes(), nodes=rnode)
    for mem in MEMS:
        for cap in _caps_bytes():
            assert got.tuned_index(mem, cap) == want.tuned_index(mem, cap), \
                (node_name, mem, cap)


def test_multi_node_table_and_subset_match_reference(ref):
    nodes = tuple(tech.NODES.values())
    rnodes = tuple(ref.tech.NODES.values())
    got = engine.design_table(MEMS, _caps_bytes(), nodes=nodes, device="cpu")
    want = ref.engine.design_table(MEMS, _caps_bytes(), nodes=rnodes)
    for f in PPA_FIELDS:
        assert _rel(getattr(got, f), getattr(want, f)) <= REL, f
    sub = got.subset(mems=("stt", "sram"), capacities_bytes=(3 * 2**20,),
                     nodes=nodes[1:3])
    rsub = want.subset(mems=("stt", "sram"), capacities_bytes=(3 * 2**20,),
                       nodes=rnodes[1:3])
    for f in PPA_FIELDS:
        assert _rel(getattr(sub, f), getattr(rsub, f)) <= REL, f
    for nd, rnd in zip(nodes[1:3], rnodes[1:3]):
        for mem in ("stt", "sram"):
            assert _rel(got.areas(mem, nd), want.areas(mem, rnd)) <= REL
            assert sub.tuned_index(mem, 3 * 2**20, nd) \
                == rsub.tuned_index(mem, 3 * 2**20, rnd)


def algorithm1_margins(table: engine.DesignTable) -> tuple[float, float]:
    """The smallest nonzero relative gaps Algorithm 1 decides on over every
    (node, mem, capacity) of ``table``: between the best and second-best
    metric value of a (target, access) pool, and between the best and
    second-best distinct nominee's EDAP.  A gap under the 1e-12 bar could
    flip between devices; area and leakage pools are constant (their
    nominee is the pool's first org on any device)."""
    pool_gap = edap_gap = np.inf
    for n, node in enumerate(table.nodes):
        for m, mem in enumerate(table.mems):
            for c, cap in enumerate(table.capacities_bytes):
                rl, wl = table.read_latency_s[n, m, c], \
                    table.write_latency_s[n, m, c]
                re_, we_ = table.read_energy_j[n, m, c], \
                    table.write_energy_j[n, m, c]
                edap = table.edap(mem, cap, node)
                nominees = set()
                for a in range(len(cachemodel.ACCESS_TYPES)):
                    pool = table.valid[c] & (engine.ORG_ACCESS == a)
                    if not pool.any():
                        continue
                    nominees.add(int(np.flatnonzero(pool)[0]))
                    for metric in (rl, wl, re_, we_, rl * re_, wl * we_):
                        v = np.sort(metric[pool])
                        gaps = (v[1:] - v[0]) / v[0]
                        if (gaps > 0).any():
                            pool_gap = min(pool_gap, gaps[gaps > 0].min())
                        nominees.add(int(np.argmin(np.where(pool, metric,
                                                            np.inf))))
                e = np.sort(edap[sorted(nominees)])
                gaps = (e[1:] - e[0]) / e[0]
                if (gaps > 0).any():
                    edap_gap = min(edap_gap, gaps[gaps > 0].min())
    return float(pool_gap), float(edap_gap)


def test_algorithm1_has_no_near_ties_on_the_mega_grid():
    """Over the mega spec's design grid (4 nodes x 3 mems x 24 capacities)
    no decision of Algorithm 1 rests on a gap anywhere near 1e-12, so the
    tuned organizations cannot flip between devices."""
    caps = tuple(int(c * 2**20) for c in t_scn.MEGA_CAPACITIES_MB)
    table = engine.design_table(MEMS, caps, nodes=tuple(tech.NODES.values()),
                                device="cpu")
    pool_gap, edap_gap = algorithm1_margins(table)
    print(f"smallest pool gap {pool_gap:.6e}, smallest nominee EDAP gap "
          f"{edap_gap:.6e}")
    assert min(pool_gap, edap_gap) > 1e6 * REL


def test_evaluate_on_arbitrary_orgs_matches_reference(ref):
    orgs = engine.ORGS[::7]
    rorgs = ref.engine.ORGS[::7]
    nodes = tuple(tech.NODES.values())[:2]
    got = engine.evaluate((3 * 2**20, 10 * 2**20), orgs, nodes=nodes,
                          device="cpu")
    want = ref.engine.evaluate((3 * 2**20, 10 * 2**20), rorgs,
                               nodes=tuple(ref.tech.NODES.values())[:2])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float64
        assert _rel(got[k], want[k]) <= REL, k


def test_outputs_are_float64():
    """Every tensor the engines return is float64: the PPA equations' and
    the fold's torch outputs, and the host tables built from them."""
    mems = MEMS
    nodes = (tech.TECH_16NM,)
    cell, cal, is_sram, node_mat = engine._tech_matrices(
        mems, None, None, nodes, "cpu")
    put = torch.from_numpy
    out = engine.ppa_fn(put(cell), put(cal), put(is_sram),
                        put(node_mat[:, :4].copy()),
                        put(node_mat[:, 4:].copy()),
                        put(np.array([3 << 20], np.int64)),
                        put(engine.ORG_BANKS), put(engine.ORG_ROWS),
                        put(engine.ORG_COLS), put(engine.ORG_ACCESS))
    assert {v.dtype for v in out.values()} == {torch.float64}
    table = engine.design_table(mems, (3 << 20,), device="cpu")
    for f in PPA_FIELDS:
        assert getattr(table, f).dtype == np.float64, f
    stats = [workload_engine.stats_for(w, 4, False)
             for w in workloads.paper_workloads().values()]
    designs = [table.tuned(m, 3 << 20) for m in mems]
    batch = workload_engine.pack(stats)
    args = [put(a) for a in (batch.bytes_total, batch.is_write,
                             batch.reuse_distance, batch.dram_visible,
                             batch.mask, batch.macs,
                             *workload_engine._design_vectors(designs),
                             np.stack([workload_engine._platform_vector(
                                 tech.GTX_1080TI)]))]
    fold = workload_engine._fold(*args)
    assert {v.dtype for v in fold.values()} == {torch.float64}
    wt = workload_engine.evaluate(stats, designs, device="cpu")
    for f in FOLD_FIELDS:
        assert getattr(wt, f).dtype == np.float64, f
    assert workload_engine.dram_tx(stats, (1 << 20,), device="cpu").dtype \
        == np.float64


# ---------------------------------------------------------------------------
# The pure-Python scalar paths (no JAX on either side)
# ---------------------------------------------------------------------------

SAMPLED_ORGS = (
    cachemodel.CacheOrg(banks=1, rows=128, cols=256, access="normal"),
    cachemodel.CacheOrg(banks=1, rows=128, cols=256, access="sequential"),
    cachemodel.CacheOrg(banks=4, rows=512, cols=512, access="fast"),
    cachemodel.CacheOrg(banks=8, rows=1024, cols=2048, access="normal"),
    cachemodel.CacheOrg(banks=32, rows=256, cols=1024, access="sequential"),
    cachemodel.CacheOrg(banks=16, rows=1024, cols=256, access="fast"),
)


@pytest.mark.parametrize("mem", MEMS)
@pytest.mark.parametrize("node_name", ["16nm-finfet", "7nm-scaled"])
def test_engine_matches_evaluate_scalar(mem, node_name):
    node = tech.NODES[node_name]
    model = cachemodel.CacheModel(mem, node, device="cpu")
    for cap_mb in (3, 16):
        cap = cap_mb * 2**20
        batched = model.evaluate_batch(cap, SAMPLED_ORGS)
        table = engine.design_table((mem,), (cap,), nodes=node, device="cpu")
        for o in np.flatnonzero(table.valid[0])[::11]:
            b = table.design(mem, cap, int(o))
            s = model.evaluate_scalar(cap, engine.ORGS[o])
            for f in PPA_FIELDS:
                assert getattr(b, f) == pytest.approx(getattr(s, f), rel=REL)
        for org, b in zip(SAMPLED_ORGS, batched):
            s = model.evaluate_scalar(cap, org)
            for f in PPA_FIELDS:
                assert getattr(b, f) == pytest.approx(getattr(s, f), rel=REL)


@pytest.mark.parametrize("mem", MEMS)
@pytest.mark.parametrize("cap_mb", [1, 3, 10, 32])
def test_tune_matches_tune_loop(mem, cap_mb):
    cap = cap_mb * 2**20
    model = cachemodel.CacheModel(mem, device="cpu")
    loop = tuner.tune_loop(model, cap)
    batched = tuner.tune(model, cap)
    table = engine.design_table(MEMS, (cap,), device="cpu")
    assert batched.org == loop.org
    assert table.tuned(mem, cap).org == loop.org
    for f in PPA_FIELDS:
        assert getattr(batched, f) == pytest.approx(getattr(loop, f), rel=REL)


def test_fold_matches_traffic_scalar():
    """Every [scenario, design] cell against traffic.runtime / energy."""
    stats = [workload_engine.stats_for(w, b, t)
             for w in workloads.paper_workloads().values()
             for t, b in STAGES]
    caps = (1 << 20, 3 << 20, 32 << 20)
    table = engine.design_table(MEMS, caps, device="cpu")
    designs = [table.tuned(m, c) for c in caps for m in MEMS]
    for platform in tech.PLATFORMS.values():
        wt = workload_engine.evaluate(stats, designs, platform, device="cpu")
        for i, s in enumerate(stats):
            assert wt.l2_read_tx[i] == pytest.approx(s.l2_read_tx, rel=REL)
            for j, d in enumerate(designs):
                want = traffic.energy(s, d, platform)
                got = wt.report(i, j)
                for f in ("runtime_s", "dyn_read_j", "dyn_write_j",
                          "leak_j", "dram_j"):
                    assert getattr(got, f) == pytest.approx(
                        getattr(want, f), rel=REL)
                assert wt.runtime_nodram_s[i, j] == pytest.approx(
                    traffic.runtime(s, d, platform, include_dram=False),
                    rel=REL)
                assert wt.dram_tx[i, j] == pytest.approx(
                    s.dram_tx(d.capacity_bytes), rel=REL)


# ---------------------------------------------------------------------------
# Workload engine
# ---------------------------------------------------------------------------


def _fold_inputs(pkg_engine, pkg_we, pkg_workloads):
    caps = (1 << 20, 3 << 20, 10 << 20)
    table = pkg_engine.design_table(
        MEMS, caps, **({"device": "cpu"} if pkg_engine is engine else {}))
    designs = tuple(table.tuned(m, c) for c in caps for m in MEMS)
    stats = tuple(pkg_we.stats_for(w, b, t)
                  for w in pkg_workloads.paper_workloads().values()
                  for t, b in STAGES)
    return stats, designs


def _assert_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.scenarios == w.scenarios
        assert g.platform.name == w.platform.name
        for f in FOLD_FIELDS:
            assert _rel(getattr(g, f), getattr(w, f)) <= REL, f


@pytest.mark.parametrize("path", ["evaluate_platforms", "evaluate_bucketed",
                                  "evaluate_chunk"])
def test_fold_matches_reference(ref, path):
    stats, designs = _fold_inputs(engine, workload_engine, workloads)
    rstats, rdesigns = _fold_inputs(ref.engine, ref.workload_engine,
                                    ref.workloads)
    platforms = tuple(tech.PLATFORMS.values())
    rplatforms = tuple(ref.tech.PLATFORMS.values())
    got = getattr(workload_engine, path)(stats, designs, platforms,
                                         device="cpu")
    want = getattr(ref.workload_engine, path)(rstats, rdesigns, rplatforms)
    _assert_tables(got, want)


def test_chunk_group_matches_reference_chunks(ref):
    stats, designs = _fold_inputs(engine, workload_engine, workloads)
    rstats, rdesigns = _fold_inputs(ref.engine, ref.workload_engine,
                                    ref.workloads)
    platforms = tuple(tech.PLATFORMS.values())
    rplatforms = tuple(ref.tech.PLATFORMS.values())
    groups = workload_engine.evaluate_chunk_group(
        [stats[:5], stats[5:]], [designs[:4], designs[4:8]], platforms,
        device="cpu")
    for got, (s, d) in zip(groups, ((slice(0, 5), slice(0, 4)),
                                    (slice(5, 10), slice(4, 8)))):
        want = ref.workload_engine.evaluate_chunk(rstats[s], rdesigns[d],
                                                  rplatforms)
        _assert_tables(got, want)
    with pytest.raises(ValueError, match="share scenario"):
        workload_engine.evaluate_chunk_group(
            [stats[:5], stats[5:9]], [designs[:4], designs[4:8]], platforms,
            device="cpu")


def test_dram_tx_matches_reference(ref):
    stats, _ = _fold_inputs(engine, workload_engine, workloads)
    rstats, _ = _fold_inputs(ref.engine, ref.workload_engine, ref.workloads)
    caps = [c * 2**20 for c in (0.5, 3, 6, 7, 10, 12, 24, 96)]
    got = workload_engine.dram_tx(stats, caps, device="cpu")
    assert _rel(got, ref.workload_engine.dram_tx(rstats, caps)) <= REL


# ---------------------------------------------------------------------------
# Sweep: golden specs, mega spec sharded and unsharded
# ---------------------------------------------------------------------------


def _assert_results(got, want):
    """Rows (labels, raw and normalized metrics) and summary within REL."""
    _assert_same(got.rows(), want.rows(), "rows")
    _assert_same(got.summary(), want.summary(), "summary")
    assert [d.org.__str__() for d in got.designs] \
        == [d.org.__str__() for d in want.designs]


@pytest.mark.parametrize("name", GOLDEN_SPECS)
def test_golden_spec_matches_reference(ref, name):
    path = str(ROOT / "specs" / f"{name}.json")
    got = sweep.load_spec(path).run(device="cpu")
    want = ref.sweep.load_spec(path).run()
    _assert_results(got, want)
    assert sweep.load_spec(path).to_json() \
        == ref.sweep.load_spec(path).to_json()


@pytest.mark.parametrize("plan", [
    None,
    sweep.ShardPlan(scenario_chunk=7, design_chunk=5),
    sweep.ShardPlan(scenario_chunk=16, design_chunk=12, devices=1),
    sweep.ShardPlan(scenario_chunk=9, by_width=True, devices=1),
])
def test_mega_quick_matches_reference(ref, plan):
    spec = t_scn.mega_spec(quick=True)
    want = ref.sweep.run(ref.scenarios.mega_spec(quick=True))
    got = sweep.run(spec, plan, device="cpu")
    assert sweep.n_cells(spec) == 960
    _assert_results(got, want)
    if plan is not None:   # sharded against the port's own unsharded run
        _assert_results(got, sweep.run(spec, device="cpu"))


def test_reference_sharded_run_matches_port(ref):
    rplan = ref.sweep.ShardPlan(scenario_chunk=7, design_chunk=5)
    want = ref.sweep.run(ref.scenarios.mega_spec(quick=True), rplan)
    got = sweep.run(t_scn.mega_spec(quick=True),
                    sweep.ShardPlan(scenario_chunk=7, design_chunk=5),
                    device="cpu")
    _assert_results(got, want)


def test_merge_without_spec_is_order_invariant():
    spec = t_scn.mega_spec(quick=True)
    plan = sweep.ShardPlan(scenario_chunk=8, design_chunk=6)
    parts = list(sweep.iter_shards(spec, plan, device="cpu"))
    a = sweep.merge_results(parts, device="cpu")
    b = sweep.SweepResult.merge(parts[::-1], device="cpu")
    assert a.rows() == b.rows()
    with pytest.raises(ValueError, match="overlapping"):
        sweep.merge_results(parts + parts[:1], device="cpu")


def test_shard_plan_devices_other_than_one_raise():
    spec = t_scn.mega_spec(quick=True)
    with pytest.raises(ValueError, match=r"found \d+ CUDA device"):
        sweep.run(spec, sweep.ShardPlan(scenario_chunk=8, devices=2),
                  device="cpu")


def test_mega_spec_axes_match_reference(ref):
    """The full mega spec's axes, without evaluating it: 182 scenarios x
    288 designs x 2 platforms, up to 645 streams."""
    spec = t_scn.mega_spec()
    rspec = ref.scenarios.mega_spec()
    assert (len(spec.scenarios), len(spec.designs), len(spec.platforms)) \
        == (182, 288, 2)
    assert sweep.n_cells(spec) == ref.sweep.n_cells(rspec) == 104_832
    assert max(len(s.streams) for s in spec.scenarios) == 645
    assert [t_scn.name_of(s) for s in spec.scenarios] \
        == [ref.scenarios.name_of(s) for s in rspec.scenarios]
    assert [sweep.design_name(p) for p in spec.designs] \
        == [ref.sweep.design_name(p) for p in rspec.designs]
    for s, r in zip(spec.scenarios, rspec.scenarios):
        assert s.macs_per_batch == r.macs_per_batch
        assert [dataclasses.astuple(x) for x in s.streams] \
            == [dataclasses.astuple(x) for x in r.streams]


# ---------------------------------------------------------------------------
# The paper's analyses
# ---------------------------------------------------------------------------


def test_isocap_matches_reference(ref):
    got = isocap.analyze(device="cpu")
    want = ref.isocap.analyze()
    _assert_same(isocap.summary(got), ref.isocap.summary(want))
    for g, w in zip(got, want):
        assert (g.workload, g.training, g.batch) \
            == (w.workload, w.training, w.batch)
        for mem in MEMS:
            _assert_same(dataclasses.asdict(g.reports[mem]),
                         dataclasses.asdict(w.reports[mem]))
    fig5 = isocap.batch_sweep(workloads.alexnet(), True, device="cpu")
    rfig5 = ref.isocap.batch_sweep(ref.workloads.alexnet(), True)
    for g, w in zip(fig5, rfig5):
        for mem in ("stt", "sot"):
            _assert_same(g.norm("edp", mem, True), w.norm("edp", mem, True))


def test_isoarea_matches_reference(ref):
    d = isoarea.designs(device="cpu")
    rd = ref.isoarea.designs()
    assert (d.stt_capacity_mb, d.sot_capacity_mb) == (7, 10) \
        == (rd.stt_capacity_mb, rd.sot_capacity_mb)
    _assert_same(isoarea.summary(isoarea.analyze(device="cpu")),
                 ref.isoarea.summary(ref.isoarea.analyze()))
    _assert_same(isoarea.dram_reduction_curve(device="cpu"),
                 ref.isoarea.dram_reduction_curve())


def test_scaling_matches_reference(ref):
    rows = scaling.workload_sweep(device="cpu")
    rrows = ref.scaling.workload_sweep()
    _assert_same([dataclasses.asdict(r) for r in rows],
                 [dataclasses.asdict(r) for r in rrows])
    _assert_same(scaling.headline(rows), ref.scaling.headline(rrows))
    _assert_same([dataclasses.asdict(r) for r in scaling.ppa_sweep(
        device="cpu")],
        [dataclasses.asdict(r) for r in ref.scaling.ppa_sweep()])


def test_table2_matches_reference(ref):
    got = tuner.table2(device="cpu")
    want = ref.tuner.table2()
    assert got.keys() == want.keys()
    for col in want:
        assert str(got[col].org) == str(want[col].org)
        for f in PPA_FIELDS + ("capacity_bytes",):
            _assert_same(getattr(got[col], f), getattr(want[col], f), col)


# ---------------------------------------------------------------------------
# chip_smoke.py's reference constants, and the default device
# ---------------------------------------------------------------------------


def _chip_smoke_golden() -> dict:
    """PIPELINE_GOLDEN from chip_smoke.py, read as a literal (the script is
    not imported)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "PIPELINE_GOLDEN"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no PIPELINE_GOLDEN")


def test_chip_smoke_constants_are_the_references_numbers(ref):
    """The GPU machine has no JAX, so chip_smoke holds the port on `cuda`
    against constants; this pins those constants to the reference."""
    golden = _chip_smoke_golden()
    t2 = ref.tuner.table2()
    assert golden["table2"] == {
        col: {"capacity_bytes": d.capacity_bytes, "org": str(d.org),
              **{f: getattr(d, f) for f in PPA_FIELDS}}
        for col, d in t2.items()}
    assert golden["isocap_summary"] == ref.isocap.summary(
        ref.isocap.analyze())
    assert golden["isoarea_capacities_mb"] == {
        m: ref.tuner.iso_area_capacity(m) for m in ("stt", "sot")}
    assert golden["isoarea_summary"] == ref.isoarea.summary(
        ref.isoarea.analyze())
    assert golden["scaling_headline"] == ref.scaling.headline(
        ref.scaling.workload_sweep())
    from repro.core import dtco
    assert golden["dtco_headline"] == dtco.headline(dtco.analyze())
    assert golden["dtco_isoarea_headline"] == dtco.isoarea_headline(
        dtco.isoarea_analyze())
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "table2_cache", ROOT / "benchmarks" / "table2_cache.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert golden["table2_anchor_max_rel_err"] \
        == bench.run()["anchor_max_rel_err"]


DEFAULT_DEVICE_CALLS = {
    "engine.design_table": lambda: engine.design_table(MEMS, (3 << 20,)),
    "engine.evaluate": lambda: engine.evaluate((3 << 20,), engine.ORGS[:2]),
    "engine.sweep": lambda: engine.sweep((3 << 20,)),
    "calibration.get": lambda: calibration.get("stt"),
    "CacheModel": lambda: cachemodel.CacheModel("sot"),
    "tuner.tuned_design": lambda: tuner.tuned_design("sram", 3),
    "workload_engine.evaluate_platforms":
        lambda: workload_engine.evaluate_platforms(
            [workload_engine.stats_for(workloads.alexnet(), 4, False)], []),
    "workload_engine.dram_tx": lambda: workload_engine.dram_tx(
        [workload_engine.stats_for(workloads.alexnet(), 4, False)], [1.0]),
    "sweep.run": lambda: sweep.run(isocap.spec()),
    "sweep.run_sharded": lambda: sweep.run(
        isocap.spec(), sweep.ShardPlan(scenario_chunk=2)),
    "isocap.analyze": lambda: isocap.analyze(),
    "isoarea.analyze": lambda: isoarea.analyze(),
    "scaling.workload_sweep": lambda: scaling.workload_sweep(),
}


@pytest.mark.parametrize("entry", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry]()
