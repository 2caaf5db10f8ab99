"""Magnetic tunnel junction (MTJ) switching models — the circuit layer.

The paper (§III-A) characterizes perpendicular STT [Kim et al., CICC'15] and
SOT [Kazemi et al., TED'16] devices in SPICE against a commercial 16 nm PDK.
We cannot run a commercial PDK, so we implement the standard compact-model
physics those SPICE models encode and calibrate the device constants against
the paper's published Table I (see DESIGN.md §2, "Calibration methodology").

Switching dynamics: for write currents above the critical current Ic0 the
device is in the precessional regime, where the switching time follows

    t_sw(I) = A / (I / Ic0 - 1)            (Sun model, I > Ic0)

with A a device time constant.  Below ~1.2x Ic0 the thermally-assisted
regime takes over and the latency explodes; the characterization sweep never
selects that region.  Write energy is Joule dissipation in the write path:

    E_wr(I) = I^2 * R_path * t_sw(I)

For STT the write path is the MTJ itself (R_P / R_AP for the two switching
polarities); for SOT it is the heavy-metal line plus driver (read and write
paths are decoupled, which is the whole point of SOT).

Technology nodes: the Table I anchors are 16 nm devices.  ``device(flavor,
node)`` projects them to other nodes through the documented exponents in
``tech.MTJ_SCALING_EXPONENTS`` (ground rules per the SOT-MRAM DTCO study,
arXiv 2303.12310): STT's Ic0 is retention-pinned and barely falls while the
access drive derates — the STT scaling wall — whereas SOT's Ic0 tracks the
shrinking heavy-metal track and scales gracefully.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import tech
from repro_torch.core.tech import TechNode, TECH_16NM


@dataclasses.dataclass(frozen=True)
class MTJDevice:
    """Compact-model constants for one magnetic technology flavor."""

    name: str
    ic0_set_a: float          # critical current, set transition (P -> AP)
    ic0_reset_a: float        # critical current, reset transition (AP -> P)
    tau_set_s: float          # precessional time constant A, set
    tau_reset_s: float        # precessional time constant A, reset
    r_set_ohm: float          # effective write-path resistance, set
    r_reset_ohm: float        # effective write-path resistance, reset
    r_read_ohm: float         # read-path resistance (through MTJ)
    read_disturb_frac: float  # max I_read / Ic0 before disturb errors
    # Sensing: the bitline split must reach the sense threshold; at device
    # level the paper reports 650 ps for both flavors (same MTJ stack).
    sense_time_s: float = 650e-12


# --- Calibrated devices -----------------------------------------------------
# Anchors: paper Table I.  Derivations (V_dd = 0.8 V, I_on = 42 uA/fin):
#   STT, 4 fins -> I_wr = 168 uA.
#     set:   8.40 ns = A_set  / (168/140 - 1)        => A_set   = 1.68 ns
#     reset: 7.78 ns = A_rst  / (168/138 - 1)        => A_rst   = 1.69 ns
#     E_set   = I^2 R t = (168u)^2 R 8.40n = 1.1 pJ  => R_P     = 4.64 kOhm
#     E_reset = (168u)^2 R 7.78n          = 2.2 pJ   => R_AP    = 10.0 kOhm
#     (TMR = (R_AP - R_P)/R_P ~ 116%, a normal perpendicular-MTJ value.)
#   SOT, 3 write fins -> I_wr = 126 uA, through the heavy-metal line.
#     set:   313 ps = A_set / (126/100 - 1)          => A_set   = 81.4 ps
#     reset: 243 ps = A_rst / (126/100 - 1)          => A_rst   = 63.2 ps
#     E = 0.08 pJ = (126u)^2 R 313p                  => R_eff   = 16.1 kOhm
#     (effective write-path impedance including the write driver).
STT_16NM = MTJDevice(
    name="stt",
    ic0_set_a=140e-6,
    ic0_reset_a=138e-6,
    tau_set_s=1.68e-9,
    tau_reset_s=1.69e-9,
    r_set_ohm=4.64e3,
    r_reset_ohm=10.0e3,
    r_read_ohm=4.64e3,
    read_disturb_frac=0.60,
)

SOT_16NM = MTJDevice(
    name="sot",
    ic0_set_a=100e-6,
    ic0_reset_a=100e-6,
    tau_set_s=81.4e-12,
    tau_reset_s=63.2e-12,
    r_set_ohm=16.1e3,
    r_reset_ohm=20.7e3,   # E_reset = 0.08 pJ at 243 ps (Table I anchor)
    r_read_ohm=4.64e3,     # read still goes through the MTJ stack
    read_disturb_frac=1.0,  # decoupled read path: no write-current disturb
)

_ANCHORS = {"stt": STT_16NM, "sot": SOT_16NM}


@functools.cache
def device(flavor: str, node: TechNode = TECH_16NM) -> MTJDevice:
    """Node-projected MTJ device: the 16 nm Table I anchor scaled by the
    documented ``tech.MTJ_SCALING_EXPONENTS`` rules (Ic0, time constants,
    path resistances, sense window — each ``anchor * s**exp``).

    At the anchor s = 1.0 exactly, so every field is a bit-exact
    multiply-by-1.0 of the Table I calibration — the projection layer
    cannot drift the anchor.  ``read_disturb_frac`` is a device-topology
    property (shared vs decoupled read path), not a scaled quantity.
    """
    anchor = _ANCHORS[flavor]
    s = tech.scale_factor(node)
    exps = tech.MTJ_SCALING_EXPONENTS[flavor]
    return dataclasses.replace(
        anchor, **{f: getattr(anchor, f) * s ** e for f, e in exps.items()})


def custom_device(flavor: str, node: TechNode = TECH_16NM,
                  **overrides: float) -> MTJDevice:
    """Node-projected device with explicit field overrides — the standard
    (non-relaxed) re-evaluation entry for inverse design: a converged
    continuous leaf (say ``ic0_set_a``) replaces the projected anchor while
    every untouched field keeps its ``device(flavor, node)`` value.
    Uncached on purpose: override values come from optimizer trajectories,
    not a small enumerable grid."""
    return dataclasses.replace(device(flavor, node), **overrides)


def switching_time(dev: MTJDevice, i_write_a: float, *, reset: bool) -> float:
    """Precessional switching time; +inf below the critical current."""
    ic0 = dev.ic0_reset_a if reset else dev.ic0_set_a
    tau = dev.tau_reset_s if reset else dev.tau_set_s
    overdrive = i_write_a / ic0 - 1.0
    if overdrive <= 0.0:
        return float("inf")
    return tau / overdrive


def switching_energy(dev: MTJDevice, i_write_a: float, *, reset: bool) -> float:
    """Joule write energy I^2 * R * t_sw for the given polarity."""
    t = switching_time(dev, i_write_a, reset=reset)
    r = dev.r_reset_ohm if reset else dev.r_set_ohm
    return i_write_a * i_write_a * r * t


def sense_energy(dev: MTJDevice, i_read_a: float, vdd_v: float,
                 sense_time_s: float | None = None) -> float:
    """Read (sense) energy: the read current is drawn from VDD for the
    sensing window.  The paper's Table I values correspond to
    I_read = 146 uA (STT: 4 fins, wordline under-driven to respect the
    read-disturb limit) and I_read = 42 uA (SOT: 1-fin dedicated path)."""
    t = dev.sense_time_s if sense_time_s is None else sense_time_s
    return vdd_v * i_read_a * t


def max_read_current(dev: MTJDevice) -> float:
    """Read-disturb ceiling: the largest safe read current.  For STT the
    read current flows through the same MTJ as writes, so it must stay well
    below Ic0; SOT's decoupled path removes the limit (returns +inf)."""
    if dev.read_disturb_frac >= 1.0:
        return float("inf")
    return dev.read_disturb_frac * min(dev.ic0_set_a, dev.ic0_reset_a)
