"""Technology constants and hardware platform descriptors.

The paper characterizes bitcells in a commercial 16 nm FinFET node and runs
workloads on a GTX 1080 Ti (same node).  We keep the node parameters in one
place so the whole cross-layer stack (mtj -> bitcell -> cachemodel ->
iso-capacity / iso-area) is driven by a single technology definition, and so
a different node can be swapped in (the framework claim of the paper).

Beyond the calibrated 16 nm anchor, ``scaled_node`` projects the node
parameters to smaller feature sizes with standard post-Dennard scaling
factors (the same first-order rules NVSim's and the Mishty & Sadi DTCO
flow's cross-node projections use), so cross-node DTCO sweeps run on the
same stack: the engine batches TechNodes as a leading tensor axis and the
calibration layer derives non-anchor-node constants from the 16 nm fit
(core/calibration.py documents that rule).

Units: seconds, joules, watts, meters**2 (area in mm^2 where noted), bytes.
"""

from __future__ import annotations

import dataclasses
import re

# ---------------------------------------------------------------------------
# 16 nm FinFET node (calibrated to the paper's commercial PDK anchors)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TechNode:
    """Parameters of a logic/memory process node used by the cache model."""

    name: str = "16nm-finfet"
    feature_size_m: float = 16e-9
    vdd_v: float = 0.8
    # Per-fin drive current (order-of-magnitude FinFET value; the absolute
    # scale is calibrated out against Table I/II).
    ion_per_fin_a: float = 42e-6
    ioff_per_fin_a: float = 3e-12   # LP flavor access devices (MRAM cells)
    # SRAM bitcell (foundry 6T) — area in um^2; STT/SOT normalized to this.
    sram_cell_area_um2: float = 0.074
    # Per-cell 6T storage leakage, calibrated so the EDAP-tuned 3 MB SRAM
    # cache reproduces Table II's 6442 mW (bitcell.sram_bitcell reads this).
    sram_cell_leak_w: float = 2.143e-7
    # Sense amplifier offset target used for sensing-delay calculation.
    sense_voltage_v: float = 0.025      # 25 mV bitline split (paper §III-A)


TECH_16NM = TechNode()


# ---------------------------------------------------------------------------
# Derived nodes: Dennard-style projections from the 16 nm anchor
# ---------------------------------------------------------------------------

# Scaling exponents relative to the anchor: parameter at a scaled node is
# anchor_value * s**exp with s = feature_size / 16 nm (s < 1 for smaller
# nodes).  First-order post-Dennard rules:
#   vdd_v                  weak supply scaling (0.8 V @16 -> ~0.71 V @7)
#   ion_per_fin_a        per-fin drive roughly flat across FinFET nodes
#   ioff_per_fin_a       LP access-device leakage worsens mildly
#   sram_cell_area_um2   classical s^2 geometry scaling
#   sram_cell_leak_w     minimum-size HP 6T cell leakage worsens sharply
#                        (Vt and gate-oxide scaling) — the cross-node SRAM
#                        leakage blow-up the DTCO analysis projects
#   sense_voltage_v      sense margin held constant
SCALING_EXPONENTS = {
    "vdd_v": 0.15,
    "ion_per_fin_a": 0.0,
    "ioff_per_fin_a": -0.5,
    "sram_cell_area_um2": 2.0,
    "sram_cell_leak_w": -1.0,
    "sense_voltage_v": 0.0,
}

# Periphery-fit scaling consumed by the calibration derivation rule
# (calibration.get): logic area follows the node; periphery leakage per MB
# falls slightly (narrower devices, lower vdd_v) despite leakier transistors.
PERI_AREA_EXP = 2.0
PERI_LEAK_EXP = 0.3

# ---------------------------------------------------------------------------
# Device / bitcell / periphery projection exponents
# ---------------------------------------------------------------------------
# One documented exponent per scaled quantity, same convention as
# SCALING_EXPONENTS: value(node) = anchor_value * s**exp.  Ground rules
# follow the SOT-MRAM DTCO study of Mishty & Sadi (arXiv 2303.12310) and
# first-order MTJ scaling physics; every consumer (mtj.device,
# bitcell.characterize, cachemodel.periphery) projects from the calibrated
# 16 nm anchor through exactly one of these tables, so at s = 1 every
# projection is an exact multiply-by-1.0 (bit-identical anchor outputs).

# MTJ compact-model constants (mtj.MTJDevice fields).
#   ic0:    STT critical current is retention-pinned — the thermal stability
#           factor Delta must hold, so Ic0 barely falls with the cell (the
#           STT scaling wall); SOT's Ic0 tracks the heavy-metal track
#           cross-section and falls steeply (the DTCO study's headline).
#   tau:    precessional time constant follows the free-layer moment.
#   r_*:    junction/track resistance rises as the area shrinks at roughly
#           constant RA product (partially thinned at advanced nodes).
#   sense_time: TMR read window erodes slowly with junction scaling.
MTJ_SCALING_EXPONENTS = {
    "stt": dict(ic0_set_a=0.05, ic0_reset_a=0.05,
                tau_set_s=1.0, tau_reset_s=1.0,
                r_set_ohm=-1.0, r_reset_ohm=-1.0, r_read_ohm=-1.0,
                sense_time_s=-0.15),
    "sot": dict(ic0_set_a=0.6, ic0_reset_a=0.6,
                tau_set_s=1.0, tau_reset_s=1.0,
                r_set_ohm=-1.0, r_reset_ohm=-1.0, r_read_ohm=-1.0,
                sense_time_s=-0.15),
}

# Bitcell-level constants (bitcell.py).
#   i_read/i_write_per_fin:  MRAM access-path drive derates with vdd_v — the
#       write path must hold vdd_v headroom across the MTJ stack, eroding as
#       the supply scales (the infeasibility mechanism at deep nodes).
#   area_base:  the MTJ pillar + BEOL keep-out is via/metal-pitch limited
#       and shrinks slower than the 6T footprint, so the SRAM-normalized
#       base term *grows* at smaller nodes (density advantage erodes — the
#       cross-node iso-area capacity trend).
#   area_per_fin:  access fins are front-end devices scaling with the node
#       like the 6T cell, so their normalized contribution is flat.
#   sram_t_rw / sram_e_rw:  intrinsic 6T CV/I time and CV^2 energy.
BITCELL_SCALING_EXPONENTS = {
    "i_read_per_fin": 0.15,
    "i_write_per_fin": 0.15,
    "area_base": -0.25,
    "area_per_fin": 0.0,
    "sram_t_rw": 1.15,
    "sram_e_rw": 1.3,
}

# Periphery building blocks (cachemodel.Periphery fields).
#   t_gate_s:      FO4 delay ~ C*V/I_drive (C and V fall, drive per um flat).
#   t_sense_amp_s: latch resolve ~ C/gm.
#   e_gate_j:      CV^2 per switched gate.
#   htree_ns_per_mm:  repeated-wire delay per mm worsens as wire RC blows
#       up faster than repeaters improve (partially recovered by vdd_v/gate
#       gains — the classic interconnect-dominated regime).
#   htree_pj_per_mm_bit:  wire energy per mm*bit ~ C_wire * V^2 (per-mm
#       wire cap roughly flat, V^2 falls).
#   c_bitline/c_wordline:  per-cell wire capacitance tracks the cell pitch.
PERIPHERY_SCALING_EXPONENTS = {
    "t_gate_s": 1.15,
    "t_sense_amp_s": 1.0,
    "e_gate_j": 1.3,
    "htree_ns_per_mm": -0.5,
    "htree_pj_per_mm_bit": 0.3,
    "c_bitline_per_row_f": 1.0,
    "c_wordline_per_col_f": 1.0,
}

# Validated projection range.  The exponent tables above are first-order
# fits anchored at 16 nm and sanity-checked against the published 7 nm DTCO
# ground rules; below 7 nm (gate-all-around territory, different MTJ
# integration) they are extrapolation without evidence, so ``scaled_node``
# refuses unless explicitly overridden.
MIN_FEATURE_SIZE_M = 7e-9


def scale_factor(node: TechNode) -> float:
    """Linear feature-size factor s of `node` relative to the 16 nm anchor."""
    return node.feature_size_m / TECH_16NM.feature_size_m


def scaled_node(feature_size_m: float, name: str | None = None,
                allow_extrapolation: bool = False) -> TechNode:
    """Project the calibrated 16 nm anchor to another feature size.

    Applies the SCALING_EXPONENTS rules to every node parameter.  Nodes
    built here (and only these — plus the anchor itself) have a calibration
    derivation rule; ``calibration.get`` raises for hand-crafted nodes.

    Projection targets below ``MIN_FEATURE_SIZE_M`` (the validated 7–16 nm
    range) raise unless ``allow_extrapolation=True`` — the exponent tables
    have no evidence beyond 7 nm and extrapolating silently is exactly the
    cross-node failure mode the derivation rules exist to prevent.
    """
    if feature_size_m < MIN_FEATURE_SIZE_M and not allow_extrapolation:
        raise ValueError(
            f"feature size {feature_size_m * 1e9:g} nm is below the "
            f"validated projection range ({MIN_FEATURE_SIZE_M * 1e9:g}–"
            f"{TECH_16NM.feature_size_m * 1e9:g} nm): the scaling exponents "
            "are fitted to 16 nm anchors and published 7 nm ground rules "
            "only; pass allow_extrapolation=True to project anyway")
    s = feature_size_m / TECH_16NM.feature_size_m
    label = name if name is not None else f"{feature_size_m * 1e9:g}nm-scaled"
    return TechNode(
        name=label,
        feature_size_m=feature_size_m,
        **{f: getattr(TECH_16NM, f) * s ** e
           for f, e in SCALING_EXPONENTS.items()},
    )


# Standard DTCO projection targets (12/10/7 nm), per the cross-node sweep.
TECH_12NM = scaled_node(12e-9)
TECH_10NM = scaled_node(10e-9)
TECH_7NM = scaled_node(7e-9)


# ---------------------------------------------------------------------------
# Node registry — symbolic name -> TechNode (SweepSpec v2 resolution)
# ---------------------------------------------------------------------------

# Canonical names of the prebuilt nodes.  ``node()`` additionally resolves
# any "<feature>nm" spelling through ``scaled_node`` (those are exactly the
# nodes that carry a calibration derivation rule), so a JSON spec can name
# an arbitrary projection target without touching Python.
NODES = {n.name: n for n in (TECH_16NM, TECH_12NM, TECH_10NM, TECH_7NM)}

_NODE_NAME_RE = re.compile(r"(\d+(?:\.\d+)?)nm(?:-scaled|-finfet)?\Z")


def node(name: str) -> TechNode:
    """Resolve a symbolic node name: a canonical registry name
    ("16nm-finfet", "7nm-scaled"), or any "<feature>nm" shorthand within the
    validated projection range, which maps to the anchor at 16 nm and to
    ``scaled_node`` otherwise.  Shorthands below ``MIN_FEATURE_SIZE_M``
    raise — a symbolic spec has no extrapolation override by design."""
    if name in NODES:
        return NODES[name]
    m = _NODE_NAME_RE.fullmatch(name)
    if m:
        # match registered nodes by their printed feature size first, so
        # "7nm" is exactly TECH_7NM (float(7) * 1e-9 != 7e-9 in binary)
        for n in NODES.values():
            if f"{n.feature_size_m * 1e9:g}" == m.group(1):
                return n
        feature_m = float(m.group(1)) * 1e-9
        if feature_m < MIN_FEATURE_SIZE_M:
            raise ValueError(
                f"technology node {name!r} is below the validated "
                f"{MIN_FEATURE_SIZE_M * 1e9:g}–"
                f"{TECH_16NM.feature_size_m * 1e9:g} nm projection range; "
                "symbolic specs cannot extrapolate (build such a node "
                "explicitly with tech.scaled_node(..., "
                "allow_extrapolation=True) if you really mean it)")
        return scaled_node(feature_m)
    raise ValueError(f"unknown technology node {name!r}; canonical names: "
                     f"{sorted(NODES)} (or any '<feature>nm' shorthand)")


# ---------------------------------------------------------------------------
# Platform descriptors (architecture layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Platform:
    """Compute platform whose last-level buffer the study replaces."""

    name: str
    peak_flops: float                 # FLOP/s (fp32 for 1080Ti, bf16 for TPU)
    dram_bw: float                    # byte/s
    dram_energy_per_byte: float       # J/byte (off-chip access)
    dram_latency_s: float             # per-transaction latency
    llc_capacity_bytes: int           # shipped last-level buffer capacity
    llc_line_bytes: int               # transaction granularity
    llc_assoc: int
    core_clock_hz: float
    # Fraction of memory-transaction time NOT hidden by compute overlap.
    # Calibrated (see DESIGN.md §8) so SRAM-baseline energy breakdowns match
    # the paper's reported aggregates.
    mem_serialization: float = 0.35


# GTX 1080 Ti — the paper's calibration platform (16 nm, 3 MB L2, 484 GB/s
# GDDR5X, 11.3 TFLOP/s fp32, 1481 MHz base clock; Table IV).
GTX_1080TI = Platform(
    name="gtx-1080ti",
    peak_flops=11.34e12,
    dram_bw=484e9,
    # GDDR5X array + on-die interface energy (the share attributable to the
    # access itself, excluding board/PHY): ~2.5 pJ/bit.  Consistent with the
    # paper's Fig. 4/8 EDP ratios, where DRAM energy is a moderate adder.
    dram_energy_per_byte=20e-12,
    dram_latency_s=180e-9,
    llc_capacity_bytes=3 * 2**20,
    llc_line_bytes=128,
    llc_assoc=16,
    core_clock_hz=1.481e9,
)

# TPU-v5e-class target (the deployment platform for the JAX framework).
# The "LLC" here is the last-level on-chip buffer (VMEM-class capacity).
TPU_V5E = Platform(
    name="tpu-v5e",
    peak_flops=197e12,
    dram_bw=819e9,
    dram_energy_per_byte=80e-12,      # HBM2e ~10 pJ/bit
    dram_latency_s=120e-9,
    llc_capacity_bytes=48 * 2**20,
    llc_line_bytes=128,
    llc_assoc=16,                     # modeled as if HW-managed, see DESIGN
    core_clock_hz=0.94e9,
    mem_serialization=0.35,
)

TPU_ICI_BW = 50e9  # byte/s per link — used by launch/roofline.py


# ---------------------------------------------------------------------------
# Platform registry — symbolic name -> Platform (SweepSpec v2 resolution)
# ---------------------------------------------------------------------------

PLATFORMS = {p.name: p for p in (GTX_1080TI, TPU_V5E)}


def platform(name: str) -> Platform:
    """Resolve a symbolic platform name through the registry."""
    try:
        return PLATFORMS[name]
    except KeyError:
        raise ValueError(f"unknown platform {name!r}; available: "
                         f"{sorted(PLATFORMS)}") from None


def pj(x: float) -> float:
    """picojoule -> J (readability helper for tables)."""
    return x * 1e-12


def ns(x: float) -> float:
    return x * 1e-9


def mm2_from_um2(x_um2: float) -> float:
    return x_um2 * 1e-6
