"""Serializable inverse-design problems and typed results.

:class:`InverseProblem` is the ``deepnvm.inverse/1`` document: an
embedded sweepspec (``deepnvm.sweepspec/2`` — the scenarios, the corner
grid the relaxation spans, and the platforms) plus the objective, the
area-budget/target formulation, and the solver hyperparameters.  Like
the sweepspec it is strict on unknown fields and round-trips through
JSON unchanged.

:class:`InverseResult` is what the driver returns: the converged leaves
per (flavor, node) group, the relaxed optimum and its standard-path
(non-relaxed engine) re-evaluation with the measured parity, the nearest
grid corner and the grid-argmin reference value, active constraints,
and the per-start loss trajectory.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Mapping

from repro_torch.core import sweep as sweep_mod
from repro_torch.core.cachemodel import CacheDesign

SCHEMA = "deepnvm.inverse/1"

OBJECTIVES = ("edp", "edap")


@dataclasses.dataclass(frozen=True)
class InverseProblem:
    """One inverse-design question, serializable as ``deepnvm.inverse/1``.

    ``sweep`` declares the corner grid the relaxation spans (its design
    points become the softmin corner axis; its NVM (flavor, node) pairs
    become the leaf groups).  ``area_budget_mm2`` is a float budget,
    ``"iso"`` (the max area over the grid corners — the iso-area
    formulation), or None (unconstrained).  ``target`` switches from
    minimization to target-hitting: loss (ln obj - ln target)^2.
    """

    sweep: sweep_mod.SymbolicSweepSpec
    objective: str = "edp"
    include_dram: bool = False
    area_budget_mm2: float | str | None = "iso"
    target: float | None = None
    name: str = "inverse"
    starts: int = 8
    iters: int = 150
    temp_hi: float = 1.0
    temp_lo: float = 1e-2
    lr: float = 0.05
    seed: int = 0

    def __post_init__(self) -> None:
        if self.objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {self.objective!r}; "
                             f"known: {OBJECTIVES}")
        if isinstance(self.area_budget_mm2, str) \
                and self.area_budget_mm2 != "iso":
            raise ValueError("area_budget_mm2 must be a number, 'iso', or "
                             f"null, not {self.area_budget_mm2!r}")
        if self.starts < 1 or self.iters < 1:
            raise ValueError("starts and iters must be >= 1")
        if not 0.0 < self.temp_lo <= self.temp_hi:
            raise ValueError("need 0 < temp_lo <= temp_hi")

    # -- (de)serialization -------------------------------------------------

    def to_doc(self) -> dict:
        doc: dict = {"schema": SCHEMA,
                     "name": self.name,
                     "sweep": self.sweep.to_doc(),
                     "objective": self.objective}
        if self.include_dram:
            doc["include_dram"] = True
        if self.area_budget_mm2 is not None:
            doc["area_budget_mm2"] = self.area_budget_mm2
        if self.target is not None:
            doc["target"] = self.target
        doc.update(starts=self.starts, iters=self.iters,
                   temp_hi=self.temp_hi, temp_lo=self.temp_lo,
                   lr=self.lr, seed=self.seed)
        return doc

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_doc(), indent=indent) + "\n"

    @classmethod
    def from_json(cls, doc: str | Mapping) -> InverseProblem:
        if not isinstance(doc, Mapping):
            doc = json.loads(doc)
        if doc.get("schema") != SCHEMA:
            raise ValueError(f"unsupported problem schema "
                             f"{doc.get('schema')!r} (this build reads "
                             f"{SCHEMA!r})")
        known = {"schema", "name", "sweep", "objective", "include_dram",
                 "area_budget_mm2", "target", "starts", "iters",
                 "temp_hi", "temp_lo", "lr", "seed"}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(f"unknown problem fields {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if "sweep" not in doc:
            raise ValueError("problem document lacks 'sweep'")
        kwargs = {k: doc[k] for k in known - {"schema", "sweep"} if k in doc}
        return cls(sweep=sweep_mod.SymbolicSweepSpec.from_json(doc["sweep"]),
                   **kwargs)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> InverseProblem:
        with open(path) as f:
            return cls.from_json(f.read())


@dataclasses.dataclass(frozen=True)
class InverseResult:
    """Converged inverse design plus everything needed to audit it."""

    problem: InverseProblem
    leaves: dict[tuple[str, str], dict[str, float]]  # (flavor, node) -> leaf
    objective: str
    best_value: float            # relaxed optimum (hardened selection)
    standard_value: float        # same point through the standard engine
    parity_rel_err: float        # |best - standard| / standard
    grid_best_value: float       # grid-argmin reference (anchor leaves)
    corner: dict                 # winning (mem, capacity_mb, node, org)
    design: CacheDesign          # standard-path design at the optimum
    area_mm2: float
    area_budget_mm2: float | None
    trajectory: tuple[float, ...]       # best start's per-iter loss
    start_losses: tuple[float, ...]     # final loss per start
    converged_start: int
    iterations: int
    n_starts: int
    active_constraints: dict[str, object]

    @property
    def gain_vs_grid(self) -> float:
        """Fractional objective improvement over the grid argmin."""
        return 1.0 - self.best_value / self.grid_best_value

    def to_doc(self) -> dict:
        return {
            "schema": "deepnvm.inverse_result/1",
            "problem": self.problem.to_doc(),
            "leaves": {"/".join(k): v for k, v in self.leaves.items()},
            "objective": self.objective,
            "best_value": self.best_value,
            "standard_value": self.standard_value,
            "parity_rel_err": self.parity_rel_err,
            "grid_best_value": self.grid_best_value,
            "gain_vs_grid": self.gain_vs_grid,
            "corner": self.corner,
            "area_mm2": self.area_mm2,
            "area_budget_mm2": self.area_budget_mm2,
            "active_constraints": self.active_constraints,
            "converged_start": self.converged_start,
            "iterations": self.iterations,
            "n_starts": self.n_starts,
            "final_losses": list(self.start_losses),
        }

    def summary(self) -> str:
        lines = [
            f"inverse {self.problem.name}: objective={self.objective}",
            f"  best (relaxed, hardened): {self.best_value:.6e}",
            f"  standard-path re-eval:    {self.standard_value:.6e}"
            f"  (parity {self.parity_rel_err:.2e})",
            f"  grid argmin reference:    {self.grid_best_value:.6e}"
            f"  (gain {100.0 * self.gain_vs_grid:+.2f}%)",
            f"  corner: {self.corner}",
            f"  area: {self.area_mm2:.3f} mm^2"
            + (f" (budget {self.area_budget_mm2:.3f})"
               if self.area_budget_mm2 is not None else ""),
            f"  starts: {self.n_starts} x {self.iterations} iters, "
            f"winner #{self.converged_start}",
        ]
        for key, leaves in self.leaves.items():
            lines.append(f"  leaves {'/'.join(key)}:")
            for f, v in leaves.items():
                lines.append(f"    {f} = {v:.6g}")
        if self.active_constraints:
            lines.append(f"  active constraints: {self.active_constraints}")
        return "\n".join(lines)
