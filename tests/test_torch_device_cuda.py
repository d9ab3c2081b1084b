"""Fault runs on the card equal fault runs on the CPU (card only).

Every fault mask is drawn on the host, so a ``FaultModel`` run on
``device="cuda"`` must give the CPU run's bits under the same seed: the
engine on both replay variants, the Monte-Carlo sweeps, TMR, the BNN fault
sweep and a ``PlanService`` flush that mixes fault and fault-free buckets.
The ``faults`` phase of ``chip_smoke.py`` makes the same checks at its
defaults; these are the small versions. Marked ``cuda``: they skip without
a card. They import nothing of the reference package, so they run where
jax is absent.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.core import BinaryMatvecPlan  # noqa: E402
from repro_torch.device import (FaultModel, binary_matvec_sweep,  # noqa
                                bnn_accuracy_sweep, tmr_binary_matvec)

GEOM = dict(rows=64, cols=256, parts=8)
DEVICES = ("cuda", "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _points(pts):
    return [dataclasses.astuple(p) for p in pts]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("fused", "unfused"))
@pytest.mark.parametrize("B", (1, 33, 100))
def test_engine_fault_model_card_equals_cpu(cuda, B, variant):
    plan = BinaryMatvecPlan(48, 64, **GEOM)
    rng = np.random.default_rng(B)
    mems = (rng.random((B, 64, 256)) < 0.5).astype(np.uint8)
    fm = FaultModel(p_sa0=0.02, p_sa1=0.03, p_switch=0.1, p_init=0.1)
    got = [plan.execute_batch(mems, backend=f"torch-{variant}", device=d,
                              faults=fm, rng=7).mem for d in DEVICES]
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.cuda
def test_sweeps_card_equal_cpu(cuda):
    rates = [0.0, 1e-3, 1e-2]
    runs = {(d, v): _points(binary_matvec_sweep(
        rates, samples=128, backend=f"torch-{v}", device=d))
        for d in DEVICES for v in ("fused", "unfused")}
    assert len({str(r) for r in runs.values()}) == 1
    assert runs[("cuda", "fused")][0][2:4] == (0.0, 0.0)
    bnn = [_points(bnn_accuracy_sweep(rates, n_inputs=128, device=d))
           for d in DEVICES]
    assert bnn[0] == bnn[1]
    tmr = [dataclasses.astuple(tmr_binary_matvec(1e-3, samples=64,
                                                 device=d))
           for d in DEVICES]
    assert tmr[0] == tmr[1]


@pytest.mark.cuda
def test_bnn_fault_sweep_card_equals_cpu(cuda):
    from repro_torch.apps.bnn import BinaryMLP, fault_sweep
    model = BinaryMLP.from_config(n_layers=3)
    got = [_points(fault_sweep(model, [1e-3], samples=32, device=d))
           for d in DEVICES]
    assert got[0] == got[1]


@pytest.mark.cuda
def test_service_fault_flush_card_equals_cpu(cuda):
    from repro_torch.serve import PlanService
    rng = np.random.default_rng(3)
    reqs = [(rng.choice([-1, 1], (90, 200)), rng.choice([-1, 1], 200))
            for _ in range(3)]
    results = {}
    for d in DEVICES:
        svc = PlanService(seed=0, backend="kernels", device=d, **GEOM)
        tickets = [svc.submit_binary_matvec(
            A, x, faults=FaultModel.uniform(3e-3) if i < 2 else None)
            for i, (A, x) in enumerate(reqs)]
        svc.flush()
        assert [t.backend for t in tickets] == [
            "kernels:fallback-torch", "kernels:fallback-torch", "kernels"]
        results[d] = [t.result for t in tickets]
    for a, b in zip(results["cuda"], results["cpu"]):
        np.testing.assert_array_equal(a, b)
    A, x = reqs[2]
    np.testing.assert_array_equal(results["cuda"][2],
                                  np.where(A @ x >= 0, 1, -1))
