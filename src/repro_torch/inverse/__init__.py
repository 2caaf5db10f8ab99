"""Gradient-based inverse design over the DeepNVM++ PPA model, in torch.

The port's engines are float64 torch maps from device constants to EDP
on the caller's device, so questions the paper only grid-argmins —
"which device knob buys the most EDP at 7 nm?", "what pulse width and
cell footprint hit a target EDP under an area budget?" — become
gradient problems:

* :mod:`repro_torch.inverse.bounds` — the continuous *leaves*: per
  (flavor, node) device anchors (Ic0, switching time constants,
  write-path resistances, sense window) plus the fin-independent bitcell
  footprint, each bounded multiplicatively around its node-projected
  center using the documented scaling-exponent tables.
* :mod:`repro_torch.inverse.relax` — the differentiable lowering: an
  unmemoized, non-argmin variant of device -> bitcell -> periphery ->
  PPA -> workload-fold where the discrete choices (fin assignments, the
  (mem, capacity, node) corner, the 288-org grid) are temperature-
  annealed softmin mixtures, the STT scaling wall is a differentiable
  penalty, and the PPA equations are the *same* torch map
  (``engine.ppa_fn``) the memoized sweep path runs.
* :mod:`repro_torch.inverse.driver` — batched multi-start projected Adam
  (``torch.func.vmap`` over starts) solving ``minimize EDP s.t. area <=
  budget`` and target-hitting formulations, plus the standard-path
  re-evaluation (``mtj.custom_device`` + ``bitcell.assemble`` +
  ``engine.evaluate``) that verifies every converged point at <= 1e-12
  parity.
* :mod:`repro_torch.inverse.problem` — the serializable
  ``deepnvm.inverse/1`` problem document (an embedded sweepspec plus
  objective/budget/solver fields) and the typed :class:`InverseResult`.
* :mod:`repro_torch.inverse.sensitivity` — d(metric)/d(param)
  elasticity tables per (node, tech, scenario) (``torch.func.jacfwd``),
  ranking which device knob buys the most EDP at each node.

Every entry point (``lower``, ``solve``, ``grid_argmin``,
``recover_corner``, ``sensitivity_rows``) runs on ``device="cuda"``
unless the caller passes ``device="cpu"``, and raises without CUDA.
"""

from repro_torch.inverse.bounds import LEAF_FIELDS, LeafGroup, leaf_groups
from repro_torch.inverse.driver import (grid_argmin, recover_corner, solve,
                                        verify)
from repro_torch.inverse.problem import SCHEMA, InverseProblem, InverseResult
from repro_torch.inverse.relax import Lowered, lower
from repro_torch.inverse.sensitivity import sensitivity_rows

__all__ = [
    "LEAF_FIELDS", "LeafGroup", "leaf_groups",
    "grid_argmin", "recover_corner", "solve", "verify",
    "SCHEMA", "InverseProblem", "InverseResult",
    "Lowered", "lower",
    "sensitivity_rows",
]
