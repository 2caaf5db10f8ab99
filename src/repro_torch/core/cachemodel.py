"""NVSim-style cache PPA model — the microarchitecture layer.

Given a characterized bitcell (core/bitcell.py) and a cache capacity, this
model explores internal organizations (banks x subarray rows x cols, and the
NVSim access types) and produces read/write latency, read/write energy,
leakage power, and area — the quantities of paper Table II.

Structure (CACTI/NVSim lineage):

  cache = banks, H-tree-connected; bank = grid of subarrays (mats);
  subarray = rows x cols bitcell array + row decoder + wordline driver +
  bitline pairs + sense amplifiers + write drivers.

  read latency  = decoder + wordline RC + bitline development + sense +
                  way select + H-tree (in + out)
  write latency = decoder + wordline RC + cell write time + H-tree
  read energy   = sensed-bit energy + bitline charging + decoder + H-tree
  write energy  = flipped-bit write energy + bitline charging + periphery
  leakage       = storage-cell leakage (SRAM only, ~0 for MRAM) + periphery
                  leakage (decoders, sense amps, H-tree repeaters)
  area          = bitcell array area / layout efficiency + periphery area

Access types (NVSim semantics):
  normal     — tag and data in parallel, all ways sensed, way-select at the
               output mux (balanced).
  fast       — everything in parallel including data-out of all ways
               (lowest latency, highest energy).
  sequential — tag first, then only the matching data way (lowest read
               energy, highest latency).

Like NVSim against a PDK, the model's absolute scale is calibrated: per-
technology multipliers (core/calibration.py) anchor the EDAP-tuned 3 MB
(iso-capacity) and 7/10 MB (iso-area) designs to paper Table II, and the
structural model provides the scaling behaviour across 1–64 MB (Fig. 9).
The periphery building blocks (gate delay, sense amp, wire capacitances,
H-tree terms) are node-derived: :class:`Periphery` projects the 16 nm
anchor constants through ``tech.PERIPHERY_SCALING_EXPONENTS``, so a scaled
node re-times and re-energizes the periphery, not just the array.
Bit-flip statistics: MRAM writes use differential write (only flipped bits
switch; Flip-N-Write-style, standard for MRAM macros) with the measured DL
bit-flip probability FLIP_P.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import numpy as np

from repro_torch.core import tech
from repro_torch.core.bitcell import Bitcell, characterize
from repro_torch.core.tech import TechNode, TECH_16NM, mm2_from_um2

LINE_BYTES = 128          # transaction granularity (paper: 128 B lines)
ASSOC = 16                # 1080 Ti L2 associativity (Table IV)
TAG_BITS = 28             # tag + state bits per line
FLIP_P = 0.18             # measured DL-tensor bit-flip probability per write

ACCESS_TYPES = ("normal", "fast", "sequential")

# Subarray aspect design space (NVSim's internal sweep).  Public: the
# batched engine (core/engine.py) builds its structure-of-arrays org grid
# from the same choices, in the same itertools.product order.
ROW_CHOICES = (128, 256, 512, 1024)
COL_CHOICES = (256, 512, 1024, 2048)
BANK_CHOICES = (1, 2, 4, 8, 16, 32)

# Periphery timing/energy building blocks at 16 nm (pre-calibration scale).
# These are the *anchor* values; every node — including the anchor itself —
# consumes them through the ``Periphery`` projection below, so the batched
# engine and the scalar model read identical node-derived quantities.
_T_GATE = 18e-12          # FO4-ish gate delay
_T_SENSE_AMP = 110e-12    # sense-amp resolve time
_E_GATE = 0.9e-15         # per-gate switching energy
_HTREE_NS_PER_MM = 0.33   # repeated-wire delay
_HTREE_PJ_PER_MM_BIT = 0.021
_C_BITLINE_PER_ROW = 0.20e-15   # F per cell on the bitline
_C_WORDLINE_PER_COL = 0.22e-15  # F per cell on the wordline


@dataclasses.dataclass(frozen=True)
class Periphery:
    """Node-derived periphery timing/energy building blocks.

    One frozen bundle of every periphery constant the PPA equations read,
    projected from the 16 nm anchor by ``tech.PERIPHERY_SCALING_EXPONENTS``
    (each field ``anchor * s**exp``; exactly the anchor values at s = 1).
    Both the scalar :class:`CacheModel` and the batched engine
    (``engine.NODE_FIELDS``) consume these per-node values — there are no
    anchor-pinned periphery constants left in the equations.
    """

    t_gate_s: float                 # FO4-ish gate delay [s]
    t_sense_amp_s: float            # sense-amp resolve time [s]
    e_gate_j: float                 # per-gate switching energy [J]
    htree_ns_per_mm: float        # repeated-wire delay [ns/mm]
    htree_pj_per_mm_bit: float    # H-tree wire energy [pJ/(mm*bit)]
    c_bitline_per_row_f: float      # F per cell on the bitline
    c_wordline_per_col_f: float     # F per cell on the wordline

    def as_array(self) -> np.ndarray:
        """Parameter vector (float64, PERIPHERY_FIELDS order): the
        periphery suffix of one ``engine.node_row``."""
        return np.array([getattr(self, f) for f in PERIPHERY_FIELDS],
                        dtype=np.float64)


# Field order is the engine's packing order (engine.NODE_FIELDS suffix).
PERIPHERY_FIELDS = tuple(f.name for f in dataclasses.fields(Periphery))

_PERIPHERY_16NM = Periphery(
    t_gate_s=_T_GATE,
    t_sense_amp_s=_T_SENSE_AMP,
    e_gate_j=_E_GATE,
    htree_ns_per_mm=_HTREE_NS_PER_MM,
    htree_pj_per_mm_bit=_HTREE_PJ_PER_MM_BIT,
    c_bitline_per_row_f=_C_BITLINE_PER_ROW,
    c_wordline_per_col_f=_C_WORDLINE_PER_COL,
)


@functools.cache
def periphery(node: TechNode = TECH_16NM) -> Periphery:
    """The periphery building blocks at ``node``: the 16 nm anchor scaled
    field-by-field through ``tech.PERIPHERY_SCALING_EXPONENTS``."""
    s = tech.scale_factor(node)
    return Periphery(**{
        f: getattr(_PERIPHERY_16NM, f)
        * s ** tech.PERIPHERY_SCALING_EXPONENTS[f]
        for f in PERIPHERY_FIELDS})


# SRAM-only capacity-stress exponents.  Holding SRAM frequency and yield at
# LLC-scale capacities requires HP (leakier) cells, redundancy, and deeper
# banking; NVSim's SRAM designs show super-linear leakage and latency growth
# that our first-order structural terms do not capture.  The exponents are
# calibrated against the paper's §IV-C scalability claims (up to 31x/36x
# energy, 2.1x/2.6x latency, 65x/95x EDP at 32 MB) and are exactly 1.0 at
# the 3 MB Table II anchor.  MRAM arrays stay compact (0.29-0.34x cell
# area), so no stress factor applies.
_SRAM_LAT_STRESS_EXP = 0.28
_SRAM_LEAK_STRESS_EXP = 0.22
_STRESS_ANCHOR_MB = 3.0


@dataclasses.dataclass(frozen=True)
class CacheOrg:
    banks: int
    rows: int
    cols: int
    access: str

    def __str__(self) -> str:
        return f"{self.banks}b x {self.rows}r x {self.cols}c / {self.access}"


@dataclasses.dataclass(frozen=True)
class CacheDesign:
    """One evaluated cache design point — a paper Table II column."""

    mem: str
    capacity_bytes: int
    org: CacheOrg
    read_latency_s: float
    write_latency_s: float
    read_energy_j: float
    write_energy_j: float
    leakage_w: float
    area_mm2: float

    @property
    def capacity_mb(self) -> float:
        return self.capacity_bytes / 2**20

    def edp_per_access(self) -> float:
        e = 0.5 * (self.read_energy_j + self.write_energy_j)
        d = 0.5 * (self.read_latency_s + self.write_latency_s)
        return e * d

    def edap(self) -> float:
        """calculate(EDAP) of paper Algorithm 1."""
        return self.edp_per_access() * self.area_mm2


def _data_bits(capacity_bytes: int) -> int:
    return capacity_bytes * 8


def _tag_bits(capacity_bytes: int) -> int:
    return (capacity_bytes // LINE_BYTES) * TAG_BITS


class CacheModel:
    """Evaluates cache design points for one memory technology."""

    def __init__(self, mem: str, node: TechNode = TECH_16NM,
                 cell: Bitcell | None = None, calibration=None,
                 device="cuda"):
        """``device`` is where the batched engine runs for this model: its
        calibration fixed point (when ``calibration`` is None) and
        ``evaluate`` / ``evaluate_batch``.  ``evaluate_scalar`` is pure
        Python and reads no device."""
        from repro_torch.core import calibration as _cal  # local: avoids cycle
        self.mem = mem
        self.node = node
        self.device = device
        self.peri = periphery(node)
        self.cell = cell if cell is not None else characterize(mem, node)
        self.cal = calibration if calibration is not None \
            else _cal.get(mem, node, device=device)

    # -- geometry ------------------------------------------------------------

    def _subarrays(self, capacity_bytes: int, org: CacheOrg) -> int:
        bits = _data_bits(capacity_bytes) + _tag_bits(capacity_bytes)
        per_subarray = org.rows * org.cols
        return max(1, math.ceil(bits / per_subarray))

    def _array_area_mm2(self, capacity_bytes: int) -> float:
        bits = _data_bits(capacity_bytes) + _tag_bits(capacity_bytes)
        cell_um2 = self.cell.area_norm * self.node.sram_cell_area_um2
        return mm2_from_um2(bits * cell_um2) / 0.85  # layout efficiency

    def _periphery_area_mm2(self, capacity_bytes: int) -> float:
        # Decoders/sense-amps/H-tree: linear + sqrt(capacity) terms; the
        # coefficients are per-technology (bigger drive -> bigger drivers)
        # and carry the Table II calibration.
        cap_mb = capacity_bytes / 2**20
        return self.cal.peri_area_lin * cap_mb + self.cal.peri_area_sqrt * math.sqrt(cap_mb)

    def area_mm2(self, capacity_bytes: int) -> float:
        return self._array_area_mm2(capacity_bytes) + self._periphery_area_mm2(capacity_bytes)

    def _htree_mm(self, capacity_bytes: int, org: CacheOrg) -> float:
        # Half-perimeter of the die area occupied by the cache, as the
        # average H-tree route; deeper banking shortens per-bank segments
        # but adds hops — net modeled as sqrt(area)*(1 + log2(banks)/8).
        side = math.sqrt(self.area_mm2(capacity_bytes))
        return side * (1.0 + math.log2(org.banks) / 8.0)

    def _stress(self, capacity_bytes: int, exp: float) -> float:
        if self.mem != "sram":
            return 1.0
        return (capacity_bytes / 2**20 / _STRESS_ANCHOR_MB) ** exp

    # -- latency -------------------------------------------------------------

    def _decoder_delay(self, org: CacheOrg) -> float:
        return math.log2(org.rows) * self.peri.t_gate_s

    def _wordline_delay(self, org: CacheOrg) -> float:
        c_wl = org.cols * self.peri.c_wordline_per_col_f
        return 2.2 * c_wl * (self.node.vdd_v / self.node.ion_per_fin_a) * 0.05

    def _bitline_time(self, org: CacheOrg) -> float:
        """Bitline development to the sense threshold.

        MRAM: current-mode sensing — the read current must slew the bitline
        capacitance by the sense margin, then the device sense time applies.
        SRAM: differential discharge by the (larger) cell read current.
        """
        c_bl = org.rows * self.peri.c_bitline_per_row_f
        i_read = self.cell.read_current_a
        t_slew = c_bl * self.node.sense_voltage_v / i_read
        return t_slew + self.cell.sense_latency_s + self.peri.t_sense_amp_s

    def _routing_delay(self, capacity_bytes: int, org: CacheOrg) -> float:
        """Predecoder + subarray-select tree: grows with subarray count —
        the term that penalizes over-fragmented organizations and gives
        Algorithm 1 an interior optimum."""
        n_sub = self._subarrays(capacity_bytes, org)
        return 2.0 * self.peri.t_gate_s * math.log2(max(2, n_sub))

    def read_latency(self, capacity_bytes: int, org: CacheOrg) -> float:
        ht = self._htree_mm(capacity_bytes, org) \
            * self.peri.htree_ns_per_mm * 1e-9
        route = self._routing_delay(capacity_bytes, org)
        array = self._decoder_delay(org) + self._wordline_delay(org) + self._bitline_time(org)
        tag = self._decoder_delay(org) + self._wordline_delay(org) + 0.4 * self._bitline_time(org)
        if org.access == "sequential":
            lat = ht + route + tag + array + 2 * self.peri.t_gate_s
        elif org.access == "fast":
            lat = ht + route + array + self.peri.t_gate_s
        else:  # normal: tag || data, way-select mux at the end
            lat = ht + route + max(tag, array) + 3 * self.peri.t_gate_s
        return lat * self.cal.k_read_lat \
            * self._stress(capacity_bytes, _SRAM_LAT_STRESS_EXP)

    def write_latency(self, capacity_bytes: int, org: CacheOrg) -> float:
        ht = self._htree_mm(capacity_bytes, org) \
            * self.peri.htree_ns_per_mm * 1e-9
        lat = (ht + self._routing_delay(capacity_bytes, org)
               + self._decoder_delay(org) + self._wordline_delay(org)
               + self.cell.write_latency_avg_s)
        return lat * self.cal.k_write_lat \
            * self._stress(capacity_bytes, _SRAM_LAT_STRESS_EXP)

    # -- energy ---------------------------------------------------------------

    def read_energy(self, capacity_bytes: int, org: CacheOrg) -> float:
        bits = LINE_BYTES * 8
        ways_sensed = {"normal": ASSOC, "fast": ASSOC, "sequential": 1}[org.access]
        sense = bits * ways_sensed * self.cell.sense_energy_j
        # bitline charging: read current drawn for the bitline time across
        # the sensed columns
        c_bl = org.rows * self.peri.c_bitline_per_row_f
        bitline = bits * ways_sensed * c_bl * self.node.vdd_v * self.node.vdd_v
        ht = (self._htree_mm(capacity_bytes, org)
              * self.peri.htree_pj_per_mm_bit * 1e-12 * bits)
        decoder = math.log2(org.rows) * 64 * self.peri.e_gate_j
        route = self._subarrays(capacity_bytes, org) * 4 * self.peri.e_gate_j
        return (sense + bitline + ht + decoder + route) * self.cal.k_read_e

    def write_energy(self, capacity_bytes: int, org: CacheOrg) -> float:
        bits = LINE_BYTES * 8
        flips = bits * (FLIP_P if self.mem != "sram" else 1.0)
        cellw = flips * self.cell.write_energy_avg_j
        c_bl = org.rows * self.peri.c_bitline_per_row_f
        bitline = bits * c_bl * self.node.vdd_v * self.node.vdd_v * 2.0
        ht = (self._htree_mm(capacity_bytes, org)
              * self.peri.htree_pj_per_mm_bit * 1e-12 * bits)
        decoder = math.log2(org.rows) * 64 * self.peri.e_gate_j
        route = self._subarrays(capacity_bytes, org) * 4 * self.peri.e_gate_j
        return (cellw + bitline + ht + decoder + route) * self.cal.k_write_e

    # -- leakage ---------------------------------------------------------------

    def leakage_w(self, capacity_bytes: int, org: CacheOrg) -> float:
        del org  # periphery leakage is carried by the calibrated fit
        bits = _data_bits(capacity_bytes) + _tag_bits(capacity_bytes)
        cells = bits * self.cell.cell_leakage_w \
            * self._stress(capacity_bytes, _SRAM_LEAK_STRESS_EXP)
        cap_mb = capacity_bytes / 2**20
        peri = self.cal.leak_lin * cap_mb + self.cal.leak_sqrt * math.sqrt(cap_mb)
        return cells + peri

    # -- full evaluation ---------------------------------------------------------

    def evaluate(self, capacity_bytes: int, org: CacheOrg) -> CacheDesign:
        """One design point — a single-element batch on the engine.

        The per-quantity scalar methods above remain the pure-Python
        reference implementation (exercised by the engine parity tests and
        by ``evaluate_scalar``); this entry point shares the batched code
        path with the full sweep.
        """
        return self.evaluate_batch(capacity_bytes, (org,))[0]

    def evaluate_batch(self, capacity_bytes: int,
                       orgs) -> list[CacheDesign]:
        """Evaluate many organizations in one batched engine call."""
        from repro_torch.core import engine  # deferred: engine imports this module
        orgs = tuple(orgs)
        out = engine.evaluate((capacity_bytes,), orgs, mems=(self.mem,),
                              cells=(self.cell,), cals=(self.cal,),
                              nodes=self.node, device=self.device)
        return [CacheDesign(
            mem=self.mem,
            capacity_bytes=capacity_bytes,
            org=org,
            read_latency_s=float(out["read_latency_s"][0, 0, 0, i]),
            write_latency_s=float(out["write_latency_s"][0, 0, 0, i]),
            read_energy_j=float(out["read_energy_j"][0, 0, 0, i]),
            write_energy_j=float(out["write_energy_j"][0, 0, 0, i]),
            leakage_w=float(out["leakage_w"][0, 0, 0]),
            area_mm2=float(out["area_mm2"][0, 0, 0]),
        ) for i, org in enumerate(orgs)]

    def evaluate_scalar(self, capacity_bytes: int, org: CacheOrg) -> CacheDesign:
        """The original pure-Python evaluation (parity/benchmark reference)."""
        return CacheDesign(
            mem=self.mem,
            capacity_bytes=capacity_bytes,
            org=org,
            read_latency_s=self.read_latency(capacity_bytes, org),
            write_latency_s=self.write_latency(capacity_bytes, org),
            read_energy_j=self.read_energy(capacity_bytes, org),
            write_energy_j=self.write_energy(capacity_bytes, org),
            leakage_w=self.leakage_w(capacity_bytes, org),
            area_mm2=self.area_mm2(capacity_bytes),
        )

    def design_space(self, capacity_bytes: int):
        """All internal organizations NVSim would sweep for this capacity."""
        for banks, rows, cols, access in itertools.product(
                BANK_CHOICES, ROW_CHOICES, COL_CHOICES, ACCESS_TYPES):
            bits = _data_bits(capacity_bytes)
            if banks * rows * cols > 4 * bits:   # degenerate: mostly empty
                continue
            if bits / (banks * rows * cols) > 4096:  # too few subarrays
                continue
            yield CacheOrg(banks=banks, rows=rows, cols=cols, access=access)
