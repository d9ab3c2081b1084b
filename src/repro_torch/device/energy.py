"""Per-primitive switching-energy model, accumulated over compiled traces.

The port of ``src/repro/device/energy.py``: host numpy, a copy in the
port's own module (the pricing needs no device).

MatPIM (like most stateful-logic papers) reports latency in cycles; mMPU
viability equally hinges on energy — comparative studies of digital memristor
PIM rank designs by per-gate switching energy and EDP as much as by cycle
count. This module prices a :class:`~repro_torch.core.compile.CompiledProgram`
under a parameterized device profile:

* each **gate evaluation** (one output device in one selected row/column —
  the write-mask popcount of the op, summed over ops) costs one conditional
  output switch plus a per-input half-select/read term;
* each **bulk-init cell** (rectangle area, summed over init cycles) costs
  one SET/RESET event;
* **EDP** combines the trace energy with the cycle count at the profile's
  cycle time.

The accounting is *static* — it is derived from the trace alone (write-mask
popcounts are known at compile time), so every plan can report energy/EDP
alongside cycles without executing. It prices the worst case (every gate
evaluation switches its output); data-dependent activity factors are a
device-profile knob (``switch_activity``), not a claim.

Profiles are VTEAM-calibrated MAGIC/FELIX-style numbers (femtojoule-scale
gate events, nanosecond-scale cycles) plus two published-range corners; they
are parameters of the model, not measurements — see EXPERIMENTS.md §Energy.

This module imports nothing from ``repro_torch.core`` at import time (the
gate/mode tables below are asserted against the compiler's in
``tests/test_torch_device.py``), so the engine side can depend on the
device package without an import cycle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# Mirrors of repro_torch.core.compile.GATE_IDS order and repro_torch.core.isa
# arities / mode codes — consistency is enforced by
# tests/test_torch_device.py.
GATE_NAMES = ("NOT", "OR2", "NOR2", "NOR3", "NAND2", "MIN3", "MIN5", "OAI3")
GATE_ARITY = (1, 2, 2, 3, 2, 3, 5, 3)
M_COL, M_ROW, M_INIT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Energy/timing parameters of one memristive device corner.

    ``e_switch_fj``  — output memristor conditional SET/RESET per gate eval
    ``e_input_fj``   — per input line read / half-select per gate eval
    ``e_init_fj``    — per cell per bulk SET/RESET
    ``t_cycle_ns``   — stateful-logic cycle time
    ``switch_activity`` — fraction of gate evaluations assumed to actually
    switch the output device (1.0 = worst case, deterministic).
    """

    name: str
    e_switch_fj: float
    e_input_fj: float
    e_init_fj: float
    t_cycle_ns: float
    switch_activity: float = 1.0

    def gate_fj(self, gate_id: int) -> float:
        return (self.e_switch_fj * self.switch_activity
                + GATE_ARITY[gate_id] * self.e_input_fj)


# VTEAM-like default plus two corners bracketing the published range:
# a fast/high-voltage corner (shorter cycle, costlier switching) and a
# low-energy corner (slow conservative switching).
PROFILES: Dict[str, DeviceProfile] = {
    "vteam": DeviceProfile("vteam", e_switch_fj=6.4, e_input_fj=0.4,
                           e_init_fj=1.8, t_cycle_ns=1.5),
    "vteam-fast": DeviceProfile("vteam-fast", e_switch_fj=23.0,
                                e_input_fj=1.2, e_init_fj=5.2,
                                t_cycle_ns=1.0),
    "low-energy": DeviceProfile("low-energy", e_switch_fj=0.64,
                                e_input_fj=0.05, e_init_fj=0.2,
                                t_cycle_ns=10.0),
}

DEFAULT_PROFILE = PROFILES["vteam"]


def get_profile(profile) -> DeviceProfile:
    """Normalize ``None`` / name / :class:`DeviceProfile` into a profile.

    >>> get_profile(None).name, get_profile("low-energy").t_cycle_ns
    ('vteam', 10.0)
    """
    if profile is None:
        return DEFAULT_PROFILE
    if isinstance(profile, DeviceProfile):
        return profile
    return PROFILES[profile]


@dataclasses.dataclass
class EnergyReport:
    """Energy/EDP of one compiled trace under one device profile."""

    profile: str
    cycles: int
    gate_events: int            # gate evaluations summed over selected lines
    init_cells: int             # bulk-init cell events
    gate_fj: float              # energy of all gate evaluations
    init_fj: float              # energy of all init cells
    by_gate: Dict[str, int]     # gate-evaluation count per primitive
    t_cycle_ns: float           # carried so unregistered profiles work too

    @property
    def total_fj(self) -> float:
        return self.gate_fj + self.init_fj

    @property
    def total_nj(self) -> float:
        return self.total_fj * 1e-6

    @property
    def latency_ns(self) -> float:
        return self.cycles * self.t_cycle_ns

    @property
    def edp_fj_ns(self) -> float:
        """Energy-delay product (fJ·ns)."""
        return self.total_fj * self.latency_ns

    def __str__(self) -> str:
        return (f"EnergyReport({self.profile}: {self.cycles} cycles, "
                f"{self.gate_events} gate events, {self.init_cells} init "
                f"cells, {self.total_nj:.3f} nJ, EDP {self.edp_fj_ns:.3e} "
                f"fJ·ns)")


def trace_energy(cp, profile=None) -> EnergyReport:
    """Price a :class:`CompiledProgram` ``cp`` under ``profile``.

    Fully vectorized over the packed trace: padding gate slots and unused
    init-rectangle slots carry the all-False mask id 0, so they contribute
    zero lines/cells without any explicit masking.
    """
    prof = get_profile(profile)
    n_gates = len(GATE_NAMES)

    rcount = cp.row_masks.sum(axis=1).astype(np.int64)   # lines per row mask
    ccount = cp.col_masks.sum(axis=1).astype(np.int64)

    # participating lines per gate op: row-mask popcount in column mode,
    # col-mask popcount in row mode (clip keeps the discarded branch of the
    # where() in-bounds for the other pool's id space)
    sel_r = rcount[np.clip(cp.sel, 0, len(rcount) - 1)]  # (T, W)
    sel_c = ccount[np.clip(cp.sel, 0, len(ccount) - 1)]
    lines = np.where((cp.mode == M_COL)[:, None], sel_r, sel_c)
    lines = np.where((cp.mode == M_INIT)[:, None], 0, lines)

    by_gate_arr = np.bincount(cp.gate.ravel().astype(np.int64),
                              weights=lines.ravel(),
                              minlength=n_gates).astype(np.int64)
    gate_fj = float(sum(prof.gate_fj(g) * by_gate_arr[g]
                        for g in range(n_gates)))

    is_init = cp.mode == M_INIT
    init_cells = int((rcount[cp.init_r[is_init]]
                      * ccount[cp.init_c[is_init]]).sum())
    init_fj = prof.e_init_fj * init_cells

    return EnergyReport(
        profile=prof.name, cycles=int(cp.n_cycles),
        gate_events=int(by_gate_arr.sum()), init_cells=init_cells,
        gate_fj=gate_fj, init_fj=init_fj,
        by_gate={GATE_NAMES[g]: int(by_gate_arr[g]) for g in range(n_gates)
                 if by_gate_arr[g]},
        t_cycle_ns=prof.t_cycle_ns,
    )


def io_energy_fj(read_cells: int, write_cells: int, profile=None) -> float:
    """Energy of one crossbar↔host transfer, in fJ.

    The energy half of the inter-stage data-movement model used by
    :mod:`repro_torch.apps.pipeline` (the latency half is
    :func:`repro_torch.core.latency.host_io_cycles`). Reads are
    half-select/sense events (``e_input_fj`` per cell); writes are driven
    SET/RESET events (``e_init_fj`` per cell). Unlike the cycle cost — one
    cycle per *column*, rows in parallel — energy is paid per **cell**
    moved.

    >>> round(io_energy_fj(100, 50), 2)    # vteam: 100*0.4 + 50*1.8
    130.0
    """
    prof = get_profile(profile)
    return read_cells * prof.e_input_fj + write_cells * prof.e_init_fj


# ---------------------------------------------------------------------------
# Table-style summary over the four MatPIM algorithms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EnergyRow:
    name: str
    config: str
    cycles: int
    energy_nj: float
    edp_fj_ns: float
    gate_events: int
    init_cells: int


def energy_table(profile=None, quick: bool = False) -> List[EnergyRow]:
    """Energy/EDP for representative configs of all four algorithm plans
    (full-precision/binary × matvec/conv), from their compiled traces."""
    from ..core import (BinaryConvPlan, BinaryMatvecPlan, ConvPlan,
                        MatvecPlan)

    if quick:
        plans = [
            ("matvec", "128x8 N=16 α=1", MatvecPlan(128, 8, 16, 1)),
            ("binary-mv", "256x128 N=1", BinaryMatvecPlan(256, 128)),
            ("conv", "64x8 3x3 N=8", ConvPlan(64, 8, 3, 8)),
            ("binary-conv", "128x64 3x3 N=1", BinaryConvPlan(128, 64, 3)),
        ]
    else:
        plans = [
            ("matvec", "1024x8 N=32 α=1", MatvecPlan(1024, 8, 32, 1)),
            ("binary-mv", "1024x384 N=1", BinaryMatvecPlan(1024, 384)),
            ("conv", "1024x4 3x3 N=32", ConvPlan(1024, 4, 3, 32)),
            ("binary-conv", "1024x256 3x3 N=1",
             BinaryConvPlan(1024, 256, 3)),
        ]
    rng = np.random.default_rng(0)
    rows = []
    for name, config, plan in plans:
        if plan.program is None:  # conv plans specialize on the kernel
            k = plan.k
            kern = (rng.choice([-1, 1], size=(k, k))
                    if isinstance(plan, BinaryConvPlan)
                    else rng.integers(0, 1 << plan.N, size=(k, k)))
            plan.ensure_program(kern)
        rep = trace_energy(plan.compile(), profile)
        rows.append(EnergyRow(name, config, rep.cycles, rep.total_nj,
                              rep.edp_fj_ns, rep.gate_events,
                              rep.init_cells))
    return rows


def format_energy_rows(rows: List[EnergyRow], title: str) -> str:
    lines = [title, "-" * len(title),
             f"{'algo':<14} {'config':<20} {'cycles':>8} {'energy_nJ':>10} "
             f"{'EDP_fJ·ns':>12} {'gate_evts':>10} {'init_cells':>10}"]
    for r in rows:
        lines.append(f"{r.name:<14} {r.config:<20} {r.cycles:>8} "
                     f"{r.energy_nj:>10.3f} {r.edp_fj_ns:>12.3e} "
                     f"{r.gate_events:>10} {r.init_cells:>10}")
    return "\n".join(lines)
