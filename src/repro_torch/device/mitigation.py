"""In-crossbar fault mitigation: triple modular redundancy via MIN3.

The port of ``src/repro/device/mitigation.py``: the replicas and the vote
run on the port's executors on ``device``; the vote program goes through the
port's ``compile_program``.

The FELIX gate suite already contains a single-cycle 3-input minority gate,
so majority voting is native to the array: ``MAJ3 = NOT(MIN3)`` costs two
cycles. TMR here is **spatial** redundancy — the three replicas draw fully
independent fault realizations, *including independent stuck-at maps*,
which models three executions on three different physical arrays (temporal
re-execution on a single array would share its stuck cells across replicas
and recover only the soft-fault component; with ``FaultModel.uniform`` half
the error budget is stuck-at, so single-array numbers would sit between
``err_raw`` and ``err_tmr``). The three result bit columns are staged into
a small vote crossbar, and the majority vote itself executes in-crossbar
**under the same fault model** (the voter is not magically reliable).

Cost accounting is explicit: ``cycles_tmr = 3·plan + vote`` and
``energy_tmr = 3·E(plan) + E(vote)`` from the static trace-energy model, so
the mitigation trades off measured extra cycles/energy against recovered
accuracy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import BinaryMatvecPlan, compile_program, execute
from ..core.isa import ColOp, InitOp
from .energy import trace_energy
from .faults import FaultModel

# vote crossbar offsets (partition 0 of a small array)
_Y = (2, 3, 4)   # the three replica result columns
_T = 5           # MIN3 scratch
_OUT = 6         # majority output


def _vote_program():
    return [
        [InitOp(slice(None), [_T, _OUT], 0)],
        [ColOp("MIN3", _Y, _T, None)],
        [ColOp("NOT", (_T,), _OUT, None)],
    ]


@dataclasses.dataclass
class TMRReport:
    rate: float
    samples: int
    err_raw: float            # per-replica sign-error rate, no mitigation
    err_tmr: float            # sign-error rate after in-crossbar vote
    cycles_raw: int
    cycles_tmr: int           # 3x re-execution + vote
    energy_raw_nj: float
    energy_tmr_nj: float

    @property
    def cycle_overhead(self) -> float:
        return self.cycles_tmr / self.cycles_raw

    @property
    def energy_overhead(self) -> float:
        return self.energy_tmr_nj / self.energy_raw_nj


def tmr_binary_matvec(
    rate: float,
    samples: int = 256,
    plan: Optional[BinaryMatvecPlan] = None,
    faults: Optional[FaultModel] = None,
    profile=None,
    backend: str = "torch",
    seed: int = 0,
    device="cuda",
) -> TMRReport:
    """Measure raw vs TMR-mitigated binary-matvec error at one fault rate.

    ``faults`` defaults to :meth:`FaultModel.uniform` at ``rate``. Every
    sample gets three spatially-independent replica executions (separate
    arrays, separate stuck-at maps — see module docstring) plus one
    (faulty) in-crossbar MIN3 vote. Example::

        r = tmr_binary_matvec(1e-3, samples=512)
        r.err_raw, r.err_tmr            # e.g. 0.108 -> 0.048
        r.cycle_overhead                # ~3.01x (vote is 3 cycles)
    """
    plan = plan or BinaryMatvecPlan(48, 64, rows=64, cols=256, parts=8)
    model = faults if faults is not None else FaultModel.uniform(rate)
    rng = np.random.default_rng(seed)
    A = rng.choice([-1, 1], size=(plan.m, plan.n))
    x = rng.choice([-1, 1], size=plan.n)
    ideal, _, _ = plan.run(A, x, backend=backend, device=device)
    ideal_bits = (ideal > 0).astype(np.uint8)

    mem0 = np.zeros((plan.rows, plan.cols), dtype=np.uint8)
    plan.load_into(mem0, A, x)
    # 3 replicas x samples, each an independent fault realization
    mems = np.broadcast_to(mem0, (3 * samples,) + mem0.shape)
    res = plan.execute_batch(mems, backend=backend, device=device,
                             faults=model, rng=rng)
    y_bits = (res.mem[:, : plan.m, plan.y_off] > 0).astype(np.uint8)
    y_bits = y_bits.reshape(3, samples, plan.m)

    # stage the three replica outputs into the vote crossbar and vote
    # in-array (2 gate cycles + 1 init), under the same fault model
    vote_cols = min(64, plan.cols)
    vote_cp = compile_program(_vote_program(), plan.rows, vote_cols,
                              plan.parts, min(plan.parts, vote_cols // 2))
    vmems = np.zeros((samples, plan.rows, vote_cols), dtype=np.uint8)
    for c, col in enumerate(_Y):
        vmems[:, : plan.m, col] = y_bits[c]
    vres = execute(vote_cp, vmems, backend=backend, device=device,
                   faults=model, rng=rng)
    y_tmr = vres.mem[:, : plan.m, _OUT]

    err_raw = float((y_bits != ideal_bits[None, None]).mean())
    err_tmr = float((y_tmr != ideal_bits[None]).mean())

    e_plan = trace_energy(plan.compile(), profile)
    e_vote = trace_energy(vote_cp, profile)
    return TMRReport(
        rate=float(rate), samples=samples, err_raw=err_raw, err_tmr=err_tmr,
        cycles_raw=plan.cycles,
        cycles_tmr=3 * plan.cycles + vote_cp.n_cycles,
        energy_raw_nj=e_plan.total_nj,
        energy_tmr_nj=3 * e_plan.total_nj + e_vote.total_nj,
    )
