"""Vectorized Monte-Carlo reliability sweeps over the fault-injecting engine.

The port of ``src/repro/device/montecarlo.py``. The executors pack the batch
into 32-crossbar words on the device, and fault realizations live in the
same packed representation — so a thousand independent fault samples of one
program cost a few dozen word-level trace replays, not a thousand
interpreted runs.

Every mask is drawn on the host from a numpy ``Generator`` in the
reference's numpy order and chunking (see :mod:`repro_torch.core.engine`),
so a sweep gives the reference's ``backend="numpy"`` numbers at the same
seed, on ``torch-fused``, ``torch-unfused`` and every ``device``.

Two sweeps:

* :func:`binary_matvec_sweep` — one fixed binary-matvec instance replicated
  across the batch, each replica under an independent fault draw. Reports the
  raw accumulator **bit-error rate** (popcount-field bits vs the ideal run)
  and the **sign-error rate** of the majority outputs.
* :func:`bnn_accuracy_sweep` — end-to-end accuracy of a binary (±1-weight)
  classifier layer: each batch slot is one input vector pushed through the
  faulty in-crossbar matvec; predictions are argmax of the decoded dot
  products vs the fault-free model's predictions.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ..core import BinaryMatvecPlan
from .faults import FaultModel


@dataclasses.dataclass
class SweepPoint:
    rate: float
    samples: int
    bit_error_rate: float      # accumulator-field bits wrong vs ideal
    sign_error_rate: float     # majority outputs wrong vs ideal
    accuracy: float            # 1 - sign_error_rate (or argmax accuracy)


def _default_plan(rows=64, cols=256, parts=8, m=48, n=64) -> BinaryMatvecPlan:
    return BinaryMatvecPlan(m, n, rows=rows, cols=cols, parts=parts)


def binary_matvec_sweep(
    rates: Sequence[float],
    samples: int = 1024,
    plan: Optional[BinaryMatvecPlan] = None,
    backend: str = "torch",
    seed: int = 0,
    device="cuda",
) -> List[SweepPoint]:
    """BER / sign-error of one binary matvec vs uniform fault rate.

    All ``samples`` replicas carry the same operands; each replica draws an
    independent :meth:`FaultModel.uniform` realization. Example::

        pts = binary_matvec_sweep([1e-4, 1e-3], samples=256)
        print(format_sweep(pts, "binary matvec"))   # rate/BER/accuracy rows
    """
    plan = plan or _default_plan()
    rng = np.random.default_rng(seed)
    A = rng.choice([-1, 1], size=(plan.m, plan.n))
    x = rng.choice([-1, 1], size=plan.n)

    mem0 = np.zeros((plan.rows, plan.cols), dtype=np.uint8)
    plan.load_into(mem0, A, x)
    ideal_mem, _, _ = plan.execute(mem0, backend=backend, device=device)
    ideal = plan.decode_y(ideal_mem)
    field = plan._total_field
    ideal_bits = ideal_mem[: plan.m][:, field]

    mems = np.broadcast_to(mem0, (samples,) + mem0.shape)
    points = []
    for rate in rates:
        res = plan.execute_batch(mems, backend=backend, device=device,
                                 faults=FaultModel.uniform(rate),
                                 rng=np.random.default_rng(seed + 1))
        bits = res.mem[:, : plan.m][:, :, field]       # (S, m, W)
        y = np.stack([plan.decode_y(m) for m in res.mem])
        ber = float((bits != ideal_bits[None]).mean())
        ser = float((y != ideal[None]).mean())
        points.append(SweepPoint(rate=float(rate), samples=samples,
                                 bit_error_rate=ber, sign_error_rate=ser,
                                 accuracy=1.0 - ser))
    return points


def bnn_accuracy_sweep(
    rates: Sequence[float],
    n_inputs: int = 1024,
    classes: int = 32,
    features: int = 64,
    plan_kw: Optional[dict] = None,
    backend: str = "torch",
    seed: int = 0,
    device="cuda",
) -> List[SweepPoint]:
    """End-to-end BNN-layer classification accuracy vs uniform fault rate.

    A ±1 weight matrix W (classes × features) classifies ±1 inputs by argmax
    of ⟨W[c], x⟩, computed in-crossbar. Each of the ``n_inputs`` batch slots
    is one input vector under one independent fault draw; accuracy is scored
    against the fault-free model's predictions (so rate 0 is exactly 1.0).
    """
    kw = dict(rows=64, cols=256, parts=8)
    kw.update(plan_kw or {})
    plan = BinaryMatvecPlan(classes, features, **kw)
    rng = np.random.default_rng(seed)
    Wt = rng.choice([-1, 1], size=(classes, features))
    X = rng.choice([-1, 1], size=(n_inputs, features))

    labels = np.argmax(Wt @ X.T, axis=0)              # fault-free predictions

    mems = np.zeros((n_inputs, plan.rows, plan.cols), dtype=np.uint8)
    for j in range(n_inputs):
        plan.load_into(mems[j], Wt, X[j])

    ideal_bits = None
    points = []
    for rate in rates:
        res = plan.execute_batch(mems, backend=backend, device=device,
                                 faults=FaultModel.uniform(rate),
                                 rng=np.random.default_rng(seed + 1))
        pops = np.stack([plan.decode_popcount(res.mem[j])
                         for j in range(n_inputs)])   # (J, classes)
        preds = np.argmax(2 * pops - features, axis=1)
        acc = float((preds == labels).mean())
        if ideal_bits is None:
            field = plan._total_field
            ref = plan.execute_batch(mems, backend=backend, device=device)
            ideal_bits = ref.mem[:, : plan.m][:, :, field]
        bits = res.mem[:, : plan.m][:, :, plan._total_field]
        ber = float((bits != ideal_bits).mean())
        points.append(SweepPoint(rate=float(rate), samples=n_inputs,
                                 bit_error_rate=ber,
                                 sign_error_rate=1.0 - acc, accuracy=acc))
    return points


def format_sweep(points: List[SweepPoint], title: str) -> str:
    lines = [title, "-" * len(title),
             f"{'fault_rate':>10} {'samples':>8} {'BER':>10} "
             f"{'sign_err':>10} {'accuracy':>9}"]
    for p in points:
        lines.append(f"{p.rate:>10.1e} {p.samples:>8} "
                     f"{p.bit_error_rate:>10.4f} {p.sign_error_rate:>10.4f} "
                     f"{p.accuracy:>9.4f}")
    return "\n".join(lines)
