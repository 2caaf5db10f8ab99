"""The port's inverse designer (`repro_torch.inverse`) on the CPU.

Two families.  First, every contract of `tests/test_inverse.py` held on
the port with `device="cpu"`: finite-difference gradients on all 32
leaves of a two-node grid (rel <= 1e-5), a non-zero gradient on every
leaf, the hardened soft cell equal to `characterize` (rtol 1e-13),
centre recovery of the grid winner on isocap and dtco_isoarea, the 2 nm
scaling wall, target mode, the problem document, the sensitivity rows.

Second, the port against the JAX reference (`repro.inverse`) on the same
inputs: `soft_cell`, `loss` and `objective_matrix` within 1e-12 relative
and the gradient within 1e-10 of `jax.grad` (relative to its largest
component), at the centres (where the SOT anchor's equal Ic0s put
`min(od_set, od_reset)` on a tie) and at a seeded offset, at
temperatures 0.5 and HARD_TEMP; the iso budget within 1e-12; a 1-start
x 60-iteration solve (loss trajectory and winning leaves within 1e-9,
the same corner and active constraints, values within 1e-12, parity
<= 1e-12); the vmapped multi-start descent across a start-chunk
boundary; the elasticity table within 1e-10 with the same top knobs;
and `chip_smoke.py`'s INVERSE_GOLDEN pinned to the reference's numbers.

The reference imports `jax.experimental.enable_x64`, which JAX 0.9 no
longer has; the `ref` fixture aliases it to `jax.enable_x64` when it
first runs, never at import.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import inverse
from repro_torch.core import bitcell, tech
from repro_torch.core.sweep import SymbolicSweepSpec
from repro_torch.inverse import bounds as bounds_mod
from repro_torch.inverse import driver, relax, sensitivity

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "specs"
CPU = "cpu"
REL = 1e-12
GRAD_REL = 1e-10
SOLVE_REL = 1e-9

# Small two-node grid exercising both flavors at 16 nm and 7 nm: the
# gradient tests cover every leaf of all four (flavor, node) groups.
TWO_NODE_DOC = {
    "schema": "deepnvm.sweepspec/2", "name": "inv-two-node",
    "scenarios": ["cnn/alexnet/infer@b4", "cnn/resnet18/train@b64"],
    "designs": ["sram@3MB", "stt@3MB", "sot@3MB",
                "stt@3MB@7nm-scaled", "sot@3MB@7nm-scaled"],
    "platforms": ["gtx-1080ti"], "baseline_mem": "sram",
}


@pytest.fixture(scope="module")
def ref():
    """The JAX reference's inverse package, imported with the R1 alias."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro import inverse as rinv
    from repro.core import tech as rtech
    from repro.core.sweep import SymbolicSweepSpec as RSpec
    from repro.inverse import bounds as rbounds
    from repro.inverse import driver as rdriver
    from repro.inverse import relax as rrelax
    from repro.inverse import sensitivity as rsens
    return types.SimpleNamespace(
        jax=jax, x64=jax.enable_x64, inverse=rinv, tech=rtech, Spec=RSpec,
        bounds=rbounds, driver=rdriver, relax=rrelax, sens=rsens)


def _problems(pkg, spec_cls, doc, **kw):
    return pkg.InverseProblem(sweep=spec_cls.from_json(doc), objective="edp",
                              **kw)


def _spec_doc(name: str) -> dict:
    return json.loads((SPECS / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def two_node():
    prob = _problems(inverse, SymbolicSweepSpec, TWO_NODE_DOC)
    return relax.lower(prob, device=CPU)


@pytest.fixture(scope="module")
def isocap_pair(ref):
    """(reference Lowered, port Lowered) of isocap as an iso-area EDP
    problem."""
    doc = _spec_doc("isocap")
    with ref.x64():
        want = ref.relax.lower(_problems(ref.inverse, ref.Spec, doc,
                                         name="isocap-inv"))
    got = relax.lower(_problems(inverse, SymbolicSweepSpec, doc,
                                name="isocap-inv"), device=CPU)
    return want, got


def _solve_problem(pkg):
    return dataclasses.replace(
        pkg.InverseProblem.load(str(SPECS / "inverse_isocap.json")),
        starts=1, iters=60)


@pytest.fixture(scope="module")
def solves(ref):
    """(reference result, port result) of isocap at 1 start x 60 iters."""
    with ref.x64():
        want = ref.inverse.solve(_solve_problem(ref.inverse))
    return want, inverse.solve(_solve_problem(inverse), device=CPU)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), 1e-300)))


def _t(theta) -> torch.Tensor:
    return torch.from_numpy(np.array(theta, dtype=np.float64))


# ---------------------------------------------------------------------------
# test_inverse.py's contracts on the port
# ---------------------------------------------------------------------------


def test_gradient_matches_finite_differences_on_every_leaf(two_node):
    low = two_node
    assert low.theta0.size == 4 * bounds_mod.N_LEAVES
    # off the SOT anchor's ic0_set == ic0_reset tie, by far more than h
    rng = np.random.default_rng(7)
    theta = low.theta0 + rng.uniform(-0.02, 0.02, low.theta0.size)
    temp = 0.5
    grad = torch.func.grad(low.loss)(_t(theta), temp).numpy()
    assert np.all(np.isfinite(grad))
    h = 1e-5
    for i in range(theta.size):
        e = np.zeros_like(theta)
        e[i] = h
        fd = (float(low.loss(_t(theta + e), temp))
              - float(low.loss(_t(theta - e), temp))) / (2.0 * h)
        scale = max(abs(fd), abs(float(grad[i])), 1e-3)
        assert abs(fd - grad[i]) / scale <= 1e-5, (i, fd, grad[i])


def test_gradient_is_nonzero_on_every_leaf(two_node):
    grad = torch.func.grad(two_node.loss)(_t(two_node.theta0), 0.5)
    assert int(torch.count_nonzero(grad)) == grad.numel()


@pytest.mark.parametrize("flavor", ["stt", "sot"])
@pytest.mark.parametrize("node", [tech.TECH_16NM, tech.scaled_node(7e-9)],
                         ids=["16nm", "7nm"])
def test_hard_soft_cell_matches_characterize(flavor, node):
    groups = bounds_mod.leaf_groups([(flavor, 3 << 20, node)])
    cell, od_best = relax.soft_cell(_t(bounds_mod.pack_theta(groups)),
                                    groups[0], relax.HARD_TEMP)
    assert float(od_best) > 0.0
    np.testing.assert_allclose(cell.numpy(),
                               bitcell.characterize(flavor, node).as_array(),
                               rtol=1e-13)


@pytest.mark.parametrize("spec_name", ["isocap", "dtco_isoarea"])
def test_center_recovery_matches_grid_argmin(spec_name):
    prob = _problems(inverse, SymbolicSweepSpec, _spec_doc(spec_name),
                     name=spec_name)
    low = relax.lower(prob, device=CPU)
    grid = inverse.grid_argmin(prob, low, device=CPU)
    rec = inverse.recover_corner(prob, low, device=CPU)
    assert rec["corner"] == grid["corner"]
    assert rec["value"] == pytest.approx(grid["value"], rel=1e-12)


def test_scaling_wall_penalty_regression_at_2nm():
    n2 = tech.scaled_node(2e-9, allow_extrapolation=True)
    g2 = bounds_mod.leaf_groups([("stt", 3 << 20, n2)])[0]
    g16 = bounds_mod.leaf_groups([("stt", 3 << 20, tech.TECH_16NM)])[0]
    theta2 = _t(bounds_mod.pack_theta((g2,)))
    _, od2 = relax.soft_cell(theta2, g2, 0.5)
    _, od16 = relax.soft_cell(_t(bounds_mod.pack_theta((g16,))), g16, 0.5)

    def penalty(od):
        return relax.LAMBDA_WALL * relax.softplus(-od / relax.WALL_SCALE)

    assert float(od2) < 0.0 < float(od16)
    assert float(penalty(od2)) > 5.0
    assert float(penalty(od16)) < 1.0
    assert np.isfinite(float(penalty(od2)))
    grad = torch.func.grad(
        lambda th: penalty(relax.soft_cell(th, g2, 0.5)[1]))(theta2).numpy()
    assert np.all(np.isfinite(grad))
    assert np.any(grad != 0.0)


def test_target_mode_drives_objective_to_target(two_node):
    low = two_node
    obj, area, _ = low.objective_matrix(_t(low.theta0))
    obj, area = obj.numpy(), area.numpy()
    ki, oi = low.masked_argmin(obj, area)
    target = float(obj[ki, oi]) * 1.1
    low_t = relax.lower(dataclasses.replace(low.problem, target=target,
                                            area_budget_mm2=None),
                        device=CPU)
    loss_t = float(low_t.loss(_t(low_t.theta0), relax.HARD_TEMP))
    wall = float(low_t.wall_penalty(_t(low_t.theta0)))
    want = (np.log(float(obj[ki, oi])) - np.log(target)) ** 2 + wall
    assert loss_t >= 0.0
    assert loss_t == pytest.approx(want, rel=1e-6)


def test_problem_document_round_trip_and_strictness():
    prob = _problems(inverse, SymbolicSweepSpec, _spec_doc("isocap"),
                     name="isocap-inv")
    assert inverse.InverseProblem.from_json(prob.to_json()) == prob
    assert prob.to_doc()["schema"] == inverse.SCHEMA
    doc = prob.to_doc()
    doc["unknown_knob"] = 1
    with pytest.raises(ValueError, match="unknown_knob"):
        inverse.InverseProblem.from_json(doc)
    with pytest.raises(ValueError, match="schema"):
        inverse.InverseProblem.from_json({"schema": "bogus"})
    for field, value, match in (("objective", "power", "objective"),
                                ("area_budget_mm2", "huge", "area_budget"),
                                ("temp_lo", 0.0, "temp")):
        with pytest.raises(ValueError, match=match):
            dataclasses.replace(prob, **{field: value})


def test_shipped_inverse_spec_loads_and_lowers():
    prob = inverse.InverseProblem.load(str(SPECS / "inverse_isocap.json"))
    assert prob.objective == "edp" and prob.area_budget_mm2 == "iso"
    low = relax.lower(prob, device=CPU)
    assert low.area_budget_mm2 > 0.0
    assert {g.key[0] for g in low.groups} == {"stt", "sot"}


def test_sensitivity_rows_shape_and_finiteness(two_node):
    rows = sensitivity.sensitivity_rows(two_node.problem, two_node,
                                        device=CPU)
    # 1 platform x 2 scenarios x 4 NVM points x 8 leaves
    assert len(rows) == 1 * 2 * 4 * bounds_mod.N_LEAVES
    for r in rows:
        assert np.isfinite(r["elasticity"])
        assert r["leaf"] in bounds_mod.LEAF_FIELDS
        assert r["mem"] in ("stt", "sot")
    top = sensitivity.top_knobs(rows, n=1)
    assert len(top) == 4
    assert all(abs(t["mean_elasticity"]) > 0.0 for t in top)


def test_solve_beats_every_grid_corner_at_equal_area(solves):
    _, res = solves
    assert res.best_value < res.grid_best_value
    assert res.area_mm2 <= res.area_budget_mm2 * (1.0 + 1e-9)
    assert res.parity_rel_err <= 1e-12
    anchors = {g.key: dict(zip(bounds_mod.LEAF_FIELDS, g.centers))
               for g in relax.lower(res.problem, device=CPU).groups}
    assert any(abs(v - anchors[key][f]) / anchors[key][f] > 1e-3
               for key, leaves in res.leaves.items()
               for f, v in leaves.items())
    json.dumps(res.to_doc())
    assert "inverse" in res.summary()


# ---------------------------------------------------------------------------
# The port against the reference on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp", [0.5, relax.HARD_TEMP])
@pytest.mark.parametrize("flavor", ["stt", "sot"])
@pytest.mark.parametrize("nm", [16, 7])
def test_soft_cell_matches_reference(ref, flavor, nm, temp):
    rnode = ref.tech.TECH_16NM if nm == 16 else ref.tech.scaled_node(7e-9)
    node = tech.TECH_16NM if nm == 16 else tech.scaled_node(7e-9)
    rgroup = ref.bounds.leaf_groups([(flavor, 3 << 20, rnode)])[0]
    group = bounds_mod.leaf_groups([(flavor, 3 << 20, node)])[0]
    theta = bounds_mod.pack_theta((group,))
    np.testing.assert_array_equal(theta, ref.bounds.pack_theta((rgroup,)))
    rng = np.random.default_rng(nm)
    for th in (theta, theta + rng.uniform(-0.05, 0.05, theta.size)):
        with ref.x64():
            want, wod = ref.relax.soft_cell(ref.jax.numpy.asarray(th),
                                            rgroup, temp)
            want, wod = np.asarray(want), float(wod)
        got, od = relax.soft_cell(_t(th), group, temp)
        assert _rel(got.numpy(), want) <= REL
        assert abs(float(od) - wod) <= REL * abs(wod)


def _offset(theta):
    return theta + np.random.default_rng(11).uniform(-0.05, 0.05,
                                                     theta.size)


@pytest.mark.parametrize("temp", [0.5, relax.HARD_TEMP])
@pytest.mark.parametrize("where", ["centres", "offset"])
def test_loss_gradient_and_objective_match_reference(ref, isocap_pair,
                                                     where, temp):
    want_low, low = isocap_pair
    theta = low.theta0 if where == "centres" else _offset(low.theta0)
    np.testing.assert_array_equal(low.theta0, want_low.theta0)
    jnp = ref.jax.numpy
    with ref.x64():
        w_loss, w_grad = ref.jax.value_and_grad(want_low.loss)(
            jnp.asarray(theta), temp)
        w_obj, w_area, w_od = want_low.objective_matrix(jnp.asarray(theta),
                                                        temp)
        w_loss, w_grad = float(w_loss), np.asarray(w_grad)
        w_obj, w_area = np.asarray(w_obj), np.asarray(w_area)
    g_grad, g_loss = torch.func.grad_and_value(low.loss)(_t(theta), temp)
    g_obj, g_area, g_od = low.objective_matrix(_t(theta), temp)
    assert abs(float(g_loss) - w_loss) <= REL * abs(w_loss)
    assert (np.max(np.abs(g_grad.numpy() - w_grad))
            <= GRAD_REL * np.max(np.abs(w_grad)))
    assert _rel(g_obj.numpy(), w_obj) <= REL
    assert _rel(g_area.numpy(), w_area) <= REL
    assert _rel([float(o) for o in g_od], [float(o) for o in w_od]) <= REL


def test_iso_budget_and_grid_match_reference(ref, isocap_pair):
    want_low, low = isocap_pair
    assert abs(low.area_budget_mm2 - want_low.area_budget_mm2) \
        <= REL * want_low.area_budget_mm2
    with ref.x64():
        want = ref.inverse.grid_argmin(want_low.problem, want_low)
    got = inverse.grid_argmin(low.problem, low, device=CPU)
    assert got["corner"] == want["corner"]
    assert _rel(got["objective_matrix"], want["objective_matrix"]) <= REL
    assert _rel(got["areas_mm2"], want["areas_mm2"]) <= REL


def test_solve_matches_reference(solves):
    want, got = solves
    assert got.corner == want.corner
    assert got.active_constraints == want.active_constraints
    assert got.converged_start == want.converged_start
    assert _rel(got.trajectory, want.trajectory) <= SOLVE_REL
    winner = (got.corner["mem"], got.corner["node"])
    assert _rel(list(got.leaves[winner].values()),
                list(want.leaves[winner].values())) <= SOLVE_REL
    assert got.leaves.keys() == want.leaves.keys()
    for key in ("best_value", "grid_best_value", "standard_value"):
        assert abs(getattr(got, key) - getattr(want, key)) \
            <= REL * abs(getattr(want, key)), key
    assert got.parity_rel_err <= 1e-12


def test_multi_start_chunks_match_reference(ref, two_node, monkeypatch):
    """Three starts through the vmapped step, cut into chunks of two (a
    chunk boundary and a ragged last chunk), against the reference's
    batch of three."""
    prob = dataclasses.replace(two_node.problem, starts=3, iters=8)
    low = dataclasses.replace(two_node, problem=prob)
    starts = driver._theta_starts(low)
    with ref.x64():
        want_low = ref.relax.lower(_problems(ref.inverse, ref.Spec,
                                             TWO_NODE_DOC, starts=3,
                                             iters=8))
        w_thetas, w_losses = ref.driver._solve_starts(want_low, starts)
    np.testing.assert_array_equal(starts, ref.driver._theta_starts(want_low))
    monkeypatch.setattr(driver, "START_CHUNK", 2)
    thetas, losses = driver._solve_starts(low, starts)
    # a start drawn past the 7 nm STT wall (every fin assignment
    # infeasible) goes NaN in the reference too: NaN where it has NaN
    np.testing.assert_allclose(thetas, w_thetas, rtol=SOLVE_REL,
                               equal_nan=True)
    np.testing.assert_allclose(losses, w_losses, rtol=SOLVE_REL,
                               equal_nan=True)


def test_sensitivity_matches_reference(ref, two_node):
    with ref.x64():
        want_low = ref.relax.lower(_problems(ref.inverse, ref.Spec,
                                             TWO_NODE_DOC))
        want = ref.sens.sensitivity_rows(want_low.problem, want_low)
    got = sensitivity.sensitivity_rows(two_node.problem, two_node,
                                       device=CPU)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "elasticity"} \
            == {k: v for k, v in w.items() if k != "elasticity"}
        assert abs(g["elasticity"] - w["elasticity"]) <= 1e-10
    for g, w in zip(sensitivity.top_knobs(got, n=2),
                    ref.sens.top_knobs(want, n=2)):
        assert {k: v for k, v in g.items() if k != "mean_elasticity"} \
            == {k: v for k, v in w.items() if k != "mean_elasticity"}
        assert abs(g["mean_elasticity"] - w["mean_elasticity"]) <= 1e-10


def test_edap_objective_verifies_where_reference_raises(ref):
    """The "edap" objective: the reference's `verify` reads
    `CacheDesign.edap`, a method, as a number and raises (R12); the
    port's verifies its solve at <= 1e-12 and shares the reference's grid
    winner."""
    doc = _spec_doc("isocap")
    prob = dataclasses.replace(
        _problems(inverse, SymbolicSweepSpec, doc), objective="edap",
        starts=2, iters=30)
    res = inverse.solve(prob, device=CPU)
    assert res.parity_rel_err <= 1e-12
    assert res.best_value < res.grid_best_value
    assert res.area_mm2 <= res.area_budget_mm2 * (1.0 + 1e-9)
    with ref.x64():
        low = ref.relax.lower(dataclasses.replace(
            _problems(ref.inverse, ref.Spec, doc), objective="edap"))
        want = ref.inverse.grid_argmin(low.problem, low)
        with pytest.raises(TypeError, match="method"):
            ref.driver.verify(low, low.theta0, want["point"], want["org"])
    assert res.grid_best_value == pytest.approx(want["value"], rel=REL)


# ---------------------------------------------------------------------------
# The device, and chip_smoke's constants
# ---------------------------------------------------------------------------


def _isocap_problem():
    return _problems(inverse, SymbolicSweepSpec, _spec_doc("isocap"))


DEFAULT_DEVICE_CALLS = {
    "lower": lambda: relax.lower(_isocap_problem()),
    "solve": lambda: inverse.solve(_isocap_problem()),
    "grid_argmin": lambda: inverse.grid_argmin(_isocap_problem()),
    "recover_corner": lambda: inverse.recover_corner(_isocap_problem()),
    "sensitivity_rows": lambda: inverse.sensitivity_rows(_isocap_problem()),
}


@pytest.mark.parametrize("entry", sorted(DEFAULT_DEVICE_CALLS))
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DEFAULT_DEVICE_CALLS[entry]()


def test_lowered_on_another_device_is_refused(two_node):
    elsewhere = dataclasses.replace(two_node, device="cuda:0")
    with pytest.raises(ValueError, match="lowered on cuda:0"):
        relax.lowered_on(two_node.problem, elsewhere, CPU)


def _chip_smoke_inverse_golden() -> dict:
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "INVERSE_GOLDEN"
                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no INVERSE_GOLDEN")


def test_chip_smoke_inverse_golden_is_the_references(ref):
    """The GPU machine has no JAX: chip_smoke's phase 8 holds the port on
    `cuda` against these constants, pinned here to the reference."""
    golden = _chip_smoke_inverse_golden()
    with ref.x64():
        for name, want in golden["recover"].items():
            prob = _problems(ref.inverse, ref.Spec, _spec_doc(name),
                             name=name)
            low = ref.relax.lower(prob)
            grid = ref.inverse.grid_argmin(prob, low)
            assert want == {"corner": grid["corner"],
                            "value": grid["value"],
                            "area_mm2": grid["area_mm2"],
                            "area_budget_mm2": low.area_budget_mm2}
        res = ref.inverse.solve(ref.inverse.InverseProblem.load(
            str(SPECS / "inverse_isocap.json")))
    doc = res.to_doc()
    assert golden["shipped"] == {
        k: doc[k] for k in ("corner", "best_value", "standard_value",
                            "grid_best_value", "area_budget_mm2")}
