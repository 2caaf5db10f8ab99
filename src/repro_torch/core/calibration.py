"""Calibration of the cache model against the paper's published anchors.

The paper calibrates NVSim against a commercial 16 nm PDK; we calibrate our
structural model against the paper's own published results instead:

  * Table I  — bitcell device parameters (anchored in core/mtj.py).
  * Table II — EDAP-tuned cache designs at 3 MB (iso-capacity) and at the
               iso-area capacities (7 MB STT / 10 MB SOT).

Two kinds of constants:

  * **Absolute coefficients** (periphery area, periphery leakage): fit as
    `lin * cap_mb + sqrt * sqrt(cap_mb)` through the two Table II capacity
    anchors per technology (one anchor + a trend prior for SRAM).  These
    carry the iso-area capacity result (7 MB / 10 MB emerge from the area
    model) and the leakage scalability (Fig. 9).
  * **Multipliers** (k_* on latency/energy): ratio of the Table II value to
    the raw structural model at the EDAP-tuned 3 MB design, computed at
    import by a two-step fixed point (tune -> fit k -> re-tune -> re-fit).
    The structural model then provides org-dependence (Algorithm 1) and
    capacity scaling; the multiplier pins the absolute scale.

All paper anchor values live here so benchmarks/tests validate against a
single source of truth.

Technology nodes: the fit above is anchored at 16 nm (the paper's PDK).
``get(mem, node)`` keeps that fixed point as the single anchor and derives
non-anchor-node calibrations by scaling it — periphery area with the node's
logic-area factor, periphery leakage with the node's leakage factor, the
dimensionless k_* multipliers unchanged (the structural model they multiply
already reads the node parameters).  Only nodes produced by
``tech.scaled_node`` carry that rule; any other node raises instead of
silently inheriting 16 nm multipliers.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import device as device_mod
from repro_torch.core import tech
from repro_torch.core.tech import TechNode, TECH_16NM

# ---------------------------------------------------------------------------
# Paper anchors (single source of truth for tests/benchmarks)
# ---------------------------------------------------------------------------

# Table I (device level).  Latencies s, energies J, area normalized to SRAM.
TABLE1 = {
    "stt": dict(sense_lat=650e-12, sense_e=0.076e-12,
                wlat_set=8400e-12, wlat_reset=7780e-12,
                we_set=1.1e-12, we_reset=2.2e-12,
                fins_read=4, fins_write=4, area=0.34),
    "sot": dict(sense_lat=650e-12, sense_e=0.020e-12,
                wlat_set=313e-12, wlat_reset=243e-12,
                we_set=0.08e-12, we_reset=0.08e-12,
                fins_read=1, fins_write=3, area=0.29),
}

# Table II (cache level).  Capacities MB; latencies ns; energies nJ;
# leakage mW; area mm^2.
TABLE2 = {
    "sram": dict(cap=3, rlat=2.91, wlat=1.53, re=0.35, we=0.32,
                 leak=6442.0, area=5.53),
    "stt": dict(cap=3, rlat=2.98, wlat=9.31, re=0.81, we=0.31,
                leak=748.0, area=2.34),
    "sot": dict(cap=3, rlat=3.71, wlat=1.38, re=0.49, we=0.22,
                leak=527.0, area=1.95),
    "stt_isoarea": dict(cap=7, rlat=4.58, wlat=10.06, re=0.93, we=0.43,
                        leak=1706.0, area=5.12),
    "sot_isoarea": dict(cap=10, rlat=6.69, wlat=2.47, re=0.51, we=0.40,
                        leak=1434.0, area=5.64),
}

# Headline paper claims used by the validation benchmarks.
PAPER_CLAIMS = dict(
    isocap_edp_reduction_max=dict(stt=3.8, sot=4.7),
    isocap_area_reduction=dict(stt=2.4, sot=2.8),
    isocap_dyn_energy_x=dict(stt=2.1, sot=1.3),        # vs SRAM (higher)
    isocap_leak_reduction=dict(stt=5.9, sot=10.0),
    isocap_energy_reduction=dict(stt=5.1, sot=8.6),
    sram_read_share_of_dyn=0.83,
    isoarea_capacity_x=dict(stt=7 / 3, sot=10 / 3),
    isoarea_dram_reduction_pct=dict(stt=14.6, sot=19.8),
    isoarea_edp_reduction_with_dram=dict(stt=2.0, sot=2.3),
    isoarea_edp_reduction_no_dram=dict(stt=1.1, sot=1.2),
    isoarea_dyn_energy_x=dict(stt=2.5, sot=1.4),
    isoarea_leak_reduction=dict(stt=2.1, sot=2.3),
    isoarea_energy_reduction=dict(stt=2.0, sot=2.3),
    scaling_energy_reduction_max=dict(stt=31.2, sot=36.4),
    scaling_latency_reduction_max=dict(stt=2.1, sot=2.6),
    scaling_edp_reduction_max=dict(stt=65.0, sot=95.0),
    batch_sweep_train_edp=dict(stt=(2.3, 4.6), sot=(7.2, 7.6)),
    batch_sweep_infer_edp=dict(stt=(4.1, 5.4), sot=(7.1, 7.3)),
)

ISO_AREA_TOLERANCE = 1.02  # 10 MB SOT is 5.64 mm^2 vs 5.53 SRAM (+2%)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-technology calibration constants for CacheModel."""

    # periphery area [mm^2] = lin * cap_mb + sqrt * sqrt(cap_mb)
    peri_area_lin: float
    peri_area_sqrt: float
    # periphery leakage [W] = lin * cap_mb + sqrt * sqrt(cap_mb)
    leak_lin: float
    leak_sqrt: float
    # structural-model multipliers (1.0 = raw model)
    k_read_lat: float = 1.0
    k_write_lat: float = 1.0
    k_read_e: float = 1.0
    k_write_e: float = 1.0


# Absolute coefficients, derived in closed form from the Table II anchors
# (see DESIGN.md §2): array area = bits * cell_area / 0.85, periphery is the
# remainder; two capacities per MRAM tech give the (lin, sqrt) pair; SRAM
# has one anchor + an STT-shaped split prior.
_BASE = {
    "sram": Calibration(peri_area_lin=0.9000, peri_area_sqrt=0.3350,
                        leak_lin=0.2500, leak_sqrt=0.0879),
    "stt": Calibration(peri_area_lin=0.3842, peri_area_sqrt=0.2438,
                       leak_lin=0.2330, leak_sqrt=0.0281),
    "sot": Calibration(peri_area_lin=0.2423, peri_area_sqrt=0.3293,
                       leak_lin=0.1044, leak_sqrt=0.1234),
}


def _has_derivation_rule(node: TechNode) -> bool:
    """A node is calibratable iff it is the 16 nm anchor or was produced by
    ``tech.scaled_node`` (reconstructing it through the scaling rule is
    exact for those and only those).  The reconstruction bypasses the
    extrapolation guard: a node the caller built with
    ``allow_extrapolation=True`` still carries the derivation rule — the
    guard protects construction, not recognition."""
    return node == TECH_16NM or \
        tech.scaled_node(node.feature_size_m, name=node.name,
                         allow_extrapolation=True) == node


@functools.cache
def _get_cached(mem: str, node: TechNode, device: str) -> Calibration:
    if node != TECH_16NM:
        # Derived-node rule: the multipliers k_* are dimensionless factors
        # on the structural model — which itself reads the node parameters —
        # so they transfer from the anchor unchanged; the absolute periphery
        # fits scale with the node (logic area as s^PERI_AREA_EXP, periphery
        # leakage as s^PERI_LEAK_EXP).  Anything else (a hand-crafted node)
        # has no rule and must not silently inherit 16 nm constants — the
        # cross-node extrapolation failure mode Roy et al. (2023) warn about.
        if not _has_derivation_rule(node):
            raise ValueError(
                f"no calibration derivation rule for node {node.name!r}: "
                "use tech.TECH_16NM or a tech.scaled_node(...) projection")
        anchor_cal = _get_cached(mem, TECH_16NM, device)
        s = tech.scale_factor(node)
        return dataclasses.replace(
            anchor_cal,
            peri_area_lin=anchor_cal.peri_area_lin * s ** tech.PERI_AREA_EXP,
            peri_area_sqrt=anchor_cal.peri_area_sqrt * s ** tech.PERI_AREA_EXP,
            leak_lin=anchor_cal.leak_lin * s ** tech.PERI_LEAK_EXP,
            leak_sqrt=anchor_cal.leak_sqrt * s ** tech.PERI_LEAK_EXP,
        )

    from repro_torch.core.cachemodel import CacheModel
    from repro_torch.core.tuner import tune

    base = _BASE[mem]
    anchor = TABLE2[mem]
    cap_bytes = anchor["cap"] * 2**20
    cal = base
    for _ in range(2):  # tune -> fit -> re-tune with fitted k -> re-fit
        model = CacheModel(mem, calibration=cal, device=device)
        design = tune(model, cap_bytes)
        cal = dataclasses.replace(
            base,
            k_read_lat=anchor["rlat"] * 1e-9 / (design.read_latency_s / cal.k_read_lat),
            k_write_lat=anchor["wlat"] * 1e-9 / (design.write_latency_s / cal.k_write_lat),
            k_read_e=anchor["re"] * 1e-9 / (design.read_energy_j / cal.k_read_e),
            k_write_e=anchor["we"] * 1e-9 / (design.write_energy_j / cal.k_write_e),
        )
    return cal


def get(mem: str, node: TechNode = TECH_16NM,
        device="cuda") -> Calibration:
    """Fully fitted calibration for `mem` at `node` (cached).

    The 16 nm anchor runs the Table II fixed-point fit; nodes produced by
    ``tech.scaled_node`` derive from that fit via the documented scaling
    rule; any other node raises (no silent 16 nm reuse).  The fixed point
    tunes through the batched engine on ``device``, which is part of the
    memo key."""
    return _get_cached(mem, node, device_mod.resolve(device))


IDENTITY = Calibration(peri_area_lin=0.38, peri_area_sqrt=0.24,
                       leak_lin=0.23, leak_sqrt=0.03)
