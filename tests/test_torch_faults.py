"""``FaultModel`` sampling in the port against the reference's numpy paths.

The port draws every fault mask on the host from a numpy ``Generator`` in
the reference's order (stuck maps, then every (cycle, gate id) block, cycle
ascending and gate id ascending, duplicates included) and chunks a model
run at the reference's numpy width (64, then ``max_batch``) with one stream
across the chunks. So the same seed must give the same bits as
``repro.core.engine.execute(..., backend="numpy-fused" | "numpy-unfused")``:
on the Monte-Carlo plan (64×256, 8 partitions) at batches that straddle
the 64-wide chunking, on random programs with row-mode and init cycles, on
a program whose fused spans mix gate ids across cycles, through the tiled
wrappers and through ``PlanService(seed=…)``. Every comparison is exact
(tolerance 0: the results are bits). On the CPU (``device="cpu"``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from test_conformance import random_program  # noqa: E402

from repro.core import BinaryMatvecPlan as RefPlan  # noqa: E402
from repro.core import compile_program as ref_compile  # noqa: E402
from repro.core import execute as ref_execute  # noqa: E402
from repro.core.isa import ColOp as RefColOp  # noqa: E402
from repro.core.tiling import TiledBinaryMatvec as RefTiled  # noqa: E402
from repro.device.faults import FaultModel as RefModel  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro_torch.core import (BinaryMatvecPlan, TiledBinaryMatvec,  # noqa
                              compile_program, execute, isa)
from repro_torch.core.isa import ColOp  # noqa: E402
from repro_torch.device.faults import FaultModel  # noqa: E402
from repro_torch.obs import metrics, trace  # noqa: E402
from repro_torch.serve import PlanService  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
MODELS = {
    "stuck": dict(p_sa0=0.05, p_sa1=0.05),
    "switch": dict(p_switch=0.3),
    "init": dict(p_init=0.2),
    "all": dict(p_sa0=0.02, p_sa1=0.03, p_switch=0.1, p_init=0.1),
}
VARIANTS = ("fused", "unfused")


def port_program(prog):
    """The reference's micro-ops rebuilt as the port's (same fields)."""
    return [[getattr(isa, type(op).__name__)(**vars(op)) for op in cyc]
            for cyc in prog]


def _mems(B, rows, cols, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((B, rows, cols)) < 0.5).astype(np.uint8)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("B", (1, 33, 64, 100))
def test_model_run_matches_reference_numpy(B, model, variant):
    ref_plan, plan = RefPlan(48, 64, **GEOM), BinaryMatvecPlan(48, 64, **GEOM)
    mems = _mems(B, 64, 256, seed=B)
    want = ref_plan.execute_batch(mems, backend=f"numpy-{variant}",
                                  faults=RefModel(**MODELS[model]), rng=7)
    got = plan.execute_batch(mems, backend=f"torch-{variant}", device="cpu",
                             faults=FaultModel(**MODELS[model]), rng=7)
    np.testing.assert_array_equal(got.mem, want.mem)
    assert (got.cycles, got.stats) == (want.cycles, want.stats)
    assert got.backend == f"torch-{variant}"


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_match_reference_numpy(seed):
    """Row-mode cycles draw (cols+1, n) words, init cycles draw flips per
    entry: the random conformance programs have both."""
    prog, rows, cols, parts = random_program(seed)
    ref_cp = ref_compile(prog, rows, cols, parts, parts)
    cp = compile_program(port_program(prog), rows, cols, parts, parts)
    mems = _mems(40, rows, cols, seed=100 + seed)
    for variant in VARIANTS:
        want = ref_execute(ref_cp, mems, backend=f"numpy-{variant}",
                           faults=RefModel(**MODELS["all"]), rng=seed)
        got = execute(cp, mems, backend=f"torch-{variant}", device="cpu",
                      faults=FaultModel(**MODELS["all"]), rng=seed)
        np.testing.assert_array_equal(got.mem, want.mem, err_msg=variant)


def _mixed_gate_program():
    """Four independent column cycles over two partitions (16 columns
    each): each cycle writes NOR2 in one partition and NOT in the other,
    swapping sides every cycle, so one fused span holds both gates in both
    orders and reads only columns no cycle of the span writes."""
    prog = []
    for t in range(4):
        a, b = (0, 16) if t % 2 == 0 else (16, 0)
        prog.append([("NOR2", (a, a + 1), a + 2 + t),
                     ("NOT", (b + 1,), b + 8 + t)])
    return prog


def test_span_mixing_gate_ids_across_cycles_matches_reference():
    """The draw is per (cycle, gate), not per gate of a span: a span of
    cycles whose gates interleave consumes the stream in cycle order."""
    spec = _mixed_gate_program()
    ref_cp = ref_compile([[RefColOp(g, i, o, None) for g, i, o in cyc]
                          for cyc in spec], 16, 32, 2, 2)
    cp = compile_program([[ColOp(g, i, o, None) for g, i, o in cyc]
                          for cyc in spec], 16, 32, 2, 2)
    seg = cp.schedule.segments[0]
    assert len(cp.schedule.segments) == 1 and seg.spans == [(0, 4)]
    # gate ids (NOT=0, NOR2=2) sit in both slot orders across the span
    assert [sorted(seg.gate[j, :2].tolist()) for j in range(4)] == \
        [[0, 2]] * 4
    mems = _mems(70, 16, 32, seed=5)
    for variant in VARIANTS:
        want = ref_execute(ref_cp, mems, backend=f"numpy-{variant}",
                           faults=RefModel(p_switch=0.3), rng=11)
        got = execute(cp, mems, backend=f"torch-{variant}", device="cpu",
                      faults=FaultModel(p_switch=0.3), rng=11)
        np.testing.assert_array_equal(got.mem, want.mem, err_msg=variant)


@pytest.mark.parametrize("variant", VARIANTS)
def test_ideal_model_equals_fault_free(variant):
    plan = BinaryMatvecPlan(48, 64, **GEOM)
    mems = _mems(70, 64, 256, seed=3)
    free = plan.execute_batch(mems, backend=f"torch-{variant}", device="cpu")
    ideal = plan.execute_batch(mems, backend=f"torch-{variant}",
                               device="cpu", faults=FaultModel(), rng=1)
    np.testing.assert_array_equal(ideal.mem, free.mem)


@pytest.mark.parametrize("max_batch", (20, 64, 100))
def test_max_batch_splits_the_model_stream(max_batch):
    """``max_batch`` narrows the chunks below 64; the draws follow the
    chunks, as in the reference."""
    ref_plan, plan = RefPlan(48, 64, **GEOM), BinaryMatvecPlan(48, 64, **GEOM)
    mems = _mems(100, 64, 256, seed=9)
    fm = MODELS["all"]
    want = ref_plan.execute_batch(mems, backend="numpy", max_batch=max_batch,
                                  faults=RefModel(**fm), rng=4)
    got = plan.execute_batch(mems, backend="torch", device="cpu",
                             max_batch=max_batch, faults=FaultModel(**fm),
                             rng=4)
    np.testing.assert_array_equal(got.mem, want.mem)
    if max_batch == 20:
        whole = plan.execute_batch(mems, backend="torch", device="cpu",
                                   faults=FaultModel(**fm), rng=4)
        assert not np.array_equal(whole.mem, got.mem)


def test_kernels_and_auto_replay_fault_runs():
    plan = BinaryMatvecPlan(48, 64, **GEOM)
    mems = _mems(40, 64, 256, seed=2)
    fm = FaultModel(**MODELS["all"])
    want = plan.execute_batch(mems, backend="torch", device="cpu",
                              faults=fm, rng=3)
    for backend, label in (("kernels", "kernels:fallback-torch"),
                           ("auto", "auto:torch")):
        got = plan.execute_batch(mems, backend=backend, device="cpu",
                                 faults=fm, rng=3)
        np.testing.assert_array_equal(got.mem, want.mem)
        assert got.backend == label


def test_tiled_wrappers_share_one_stream_across_chunks():
    """90 tiles run as chunks of 64 and 26 on one shared stream."""
    rng = np.random.default_rng(8)
    M, K = 640, 900
    A = rng.choice([-1, 1], size=(M, K))
    x = rng.choice([-1, 1], size=K)
    ref, t = RefTiled(M, K, **GEOM), TiledBinaryMatvec(M, K, **GEOM)
    assert t.n_tiles == ref.n_tiles == 90
    fm = MODELS["all"]
    y_ref, _ = ref.run(A, x, faults=RefModel(**fm), rng=6)
    y, info = t.run(A, x, faults=FaultModel(**fm), rng=6, device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(t.last_popcounts, ref.last_popcounts)
    X = rng.choice([-1, 1], size=(3, K))
    got = t.popcounts_many(A, X, faults=FaultModel(**fm), rng=2,
                           device="cpu")
    want = ref.popcounts_many(A, X, faults=RefModel(**fm), rng=2)
    np.testing.assert_array_equal(got, want)


def _fault_stream(svc, model_cls):
    """Two faulty binary-matvec requests under one model value, an ideal
    one, a faulty full-precision matvec: three buckets."""
    rng = np.random.default_rng(21)
    reqs = [("binary_matvec", (rng.choice([-1, 1], (90, 200)),
                               rng.choice([-1, 1], 200)), 3e-2),
            ("binary_matvec", (rng.choice([-1, 1], (70, 150)),
                               rng.choice([-1, 1], 150)), 3e-2),
            ("binary_matvec", (rng.choice([-1, 1], (60, 100)),
                               rng.choice([-1, 1], 100)), None),
            ("matvec", (rng.integers(0, 16, (20, 12)),
                        rng.integers(0, 16, 12), 4), 1e-2)]
    tickets = []
    for kind, args, rate in reqs:
        f = model_cls.uniform(rate) if rate is not None else None
        tickets.append(svc.submit(kind, *args, faults=f))
    svc.flush()
    return tickets


def test_service_fault_stream_matches_reference_service():
    """``PlanService(seed=0)`` draws its ``FaultModel`` buckets from one
    stream in execution order, as the reference service does; equal models
    coalesce into one bucket and an ideal request keeps its own."""
    svc = PlanService(seed=0, device="cpu", **GEOM)
    ref = RefService(seed=0, **GEOM)
    for _ in range(2):          # the stream carries on across flushes
        got = _fault_stream(svc, FaultModel)
        want = _fault_stream(ref, RefModel)
        for t, r in zip(got, want):
            np.testing.assert_array_equal(t.result, r.result)
            assert (t.cycles, t.batch_units) == (r.cycles, r.batch_units)
    assert got[0].batch_units == got[0].n_units + got[1].n_units
    assert got[2].batch_units == got[2].n_units
    assert [t.backend for t in got] == ["torch"] * 4
    other = _fault_stream(PlanService(seed=1, device="cpu", **GEOM),
                          FaultModel)
    assert any(not np.array_equal(a.result, b.result)
               for a, b in zip(other, got))


def test_kernels_service_keeps_ideal_buckets_on_the_kernels():
    svc = PlanService(seed=0, backend="kernels", device="cpu", **GEOM)
    tickets = _fault_stream(svc, FaultModel)
    assert [t.backend for t in tickets] == [
        "kernels:fallback-torch", "kernels:fallback-torch", "kernels",
        "kernels:fallback-torch"]
    want = _fault_stream(PlanService(seed=0, device="cpu", **GEOM),
                         FaultModel)
    for t, w in zip(tickets, want):
        np.testing.assert_array_equal(t.result, w.result)


def test_fault_gauges_counters_and_spans():
    metrics.reset_metrics()
    plan = BinaryMatvecPlan(48, 64, **GEOM)
    mems = _mems(3, 64, 256, seed=1)
    plan.execute_batch(mems, device="cpu", faults=FaultModel(), rng=0)
    assert "engine.execute.fault_runs" not in metrics.snapshot()
    fm = FaultModel(p_sa0=0.01, p_sa1=0.02, p_switch=0.03, p_init=0.04)
    tr = trace.enable()
    try:
        plan.execute_batch(mems, device="cpu", faults=fm, rng=0)
    finally:
        trace.disable()
    snap = metrics.snapshot()
    assert snap["engine.execute.fault_runs"]["value"] == 1
    for name in ("sa0", "sa1", "switch", "init"):
        assert snap[f"engine.fault.p_{name}"]["value"] == \
            getattr(fm, f"p_{name}")
    names = {ev["name"] for ev in tr.events()}
    assert {"engine.fault.draw", "engine.fault.copy"} <= names
