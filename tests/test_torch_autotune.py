"""The port's autotuner (``repro_torch.core.autotune``) and ``backend="auto"``.

``program_key`` and ``batch_bucket`` must equal the reference's for the same
trace (the plan store's integrity check rests on them); the tunings table
keeps the reference's file format (round trip, corrupt files load empty,
schema-1/-2 demotion, rows naming the reference's backends are never
resolved) in a file of its own (``$MATPIM_TORCH_TUNINGS``). The heuristic
picks ``kernels`` for a trace the kernels compute, else fused, else
per-cycle replay; ``execute(backend="auto")`` decodes like ``torch`` with an
``auto:`` label, and a ``PlanService(backend="auto")`` tunes cold pairs
inline and serves the reference's results. CPU only (``device="cpu"``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

import repro.core as ref_core  # noqa: E402
from repro.core import autotune as ref_at  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro_torch.core import (BinaryConvPlan, BinaryMatvecPlan,  # noqa: E402
                              ConvPlan, MatvecPlan, execute)
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.serve import PlanService  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)


def _plans(mod):
    """One plan per algorithm kind, its kernel bound, from ``mod``."""
    conv = mod.ConvPlan(6, 6, 2, 4, **GEOM)
    conv.ensure_program(np.array([[1, 2], [2, 1]]))
    bconv = mod.BinaryConvPlan(6, 8, 2, **GEOM)
    bconv.ensure_program(np.array([[1, -1], [-1, 1]]))
    return {"binary_matvec": mod.BinaryMatvecPlan(4, 16, **GEOM),
            "matvec": mod.MatvecPlan(4, 8, 2, **GEOM),
            # 16-bit: over the kernels' f32 bound (a wider geometry)
            "matvec16": mod.MatvecPlan(4, 4, 16, rows=64, cols=512,
                                       parts=16),
            "conv": conv, "binary_conv": bconv}


class _Port:
    BinaryConvPlan, BinaryMatvecPlan = BinaryConvPlan, BinaryMatvecPlan
    ConvPlan, MatvecPlan = ConvPlan, MatvecPlan


@pytest.mark.parametrize("kind", ["binary_matvec", "matvec", "matvec16",
                                  "conv", "binary_conv"])
@pytest.mark.parametrize("fuse", [True, False])
def test_keys_match_reference(kind, fuse):
    cp = _plans(_Port)[kind].compile(fuse=fuse)
    ref_cp = _plans(ref_core)[kind].compile(fuse=fuse)
    assert at.program_key(cp) == ref_at.program_key(ref_cp)
    for B in (1, 31, 32, 33, 64, 65, 1000):
        assert at.batch_bucket(B) == ref_at.batch_bucket(B)


def _bmv(seed=0, m=4, n=16):
    rng = np.random.default_rng(seed)
    plan = BinaryMatvecPlan(m, n, **GEOM)
    A = rng.choice([-1, 1], size=(m, n))
    x = rng.choice([-1, 1], size=n)
    mem = np.zeros((plan.rows, plan.cols), dtype=np.uint8)
    plan.load_into(mem, A, x)
    return plan, mem, np.where(A @ x >= 0, 1, -1)


def test_table_roundtrip_and_format(tmp_path):
    p = tmp_path / "t.json"
    t = at.TuningTable(p)
    t.record("KEY", 1, "kernels", 12.5)
    t.record("KEY", 2, "torch-fused", 40.0, max_batch=32)
    t.save()
    d = json.loads(p.read_text())
    assert d["schema"] == at.SCHEMA == ref_at.SCHEMA == 3
    assert set(d["entries"]) == {"KEY|1|1", "KEY|2|1"}
    back = at.TuningTable(p)
    assert back.lookup("KEY", 1) == at.TuningEntry("kernels", 12.5)
    assert back.lookup("KEY", 2).max_batch == 32
    # the reference reads the port's file (and the port the reference's)
    assert ref_at.TuningTable(p).lookup("KEY", 2).backend == "torch-fused"
    assert not list(tmp_path.glob("*.tmp"))       # atomic save left no tmp
    assert at.TuningTable(tmp_path / "missing.json").entries() == {}


@pytest.mark.parametrize("payload", [
    "{ not json",
    json.dumps({"schema": 0, "entries": {}}),
    json.dumps({"schema": 3}),
])
def test_corrupt_or_stale_table_loads_empty(tmp_path, payload):
    p = tmp_path / "t.json"
    p.write_text(payload)
    t = at.TuningTable(p)
    assert len(t) == 0 and t.load_error is not None
    plan, mem, want = _bmv()
    res = execute(plan.compile(), mem, backend="auto", device="cpu",
                  tunings=t)
    assert res.backend == "auto:kernels"
    np.testing.assert_array_equal(plan.decode_y(res.mem), want)


def test_legacy_schemas_demote(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"schema": 1, "entries": {
        "KEY|64": {"backend": "torch-unfused", "us": 9.0},
        "KEY|32": {"backend": "kernels", "us": 3.0}}}))
    e = at.TuningTable(p).lookup("KEY", 2)
    assert (e.backend, e.source) == ("torch-unfused", "heuristic")
    assert at.TuningTable(p).lookup("KEY", 1).backend == "kernels"
    p.write_text(json.dumps({"schema": 2, "entries": {
        "KEY|64|1": {"backend": "torch-fused", "us": 9.0,
                     "source": "measured"},
        "KEY|33|1": {"backend": "torch-unfused", "us": 4.0,
                     "source": "measured"},
        "KEY|64|8": {"backend": "torch-fused", "us": 1.0}}}))
    t = at.TuningTable(p)
    e = t.lookup("KEY", 2)          # 64 and 33 both collapse onto 2 words
    assert (e.backend, e.us, e.source) == ("torch-unfused", 4.0,
                                           "heuristic")
    assert t.lookup("KEY", 2, topo=8).backend == "torch-fused"


def test_foreign_and_demoted_rows_resolve_by_heuristic():
    plan, mem, want = _bmv()
    cp = plan.compile()
    key = at.program_key(cp)
    t = at.TuningTable()
    t.record(key, 1, "numpy-fused", 1.0)        # the reference's backend
    assert at.resolve_auto(cp, 1, table=t) == ("kernels", None, "heuristic")
    t.record(key, 1, "torch-unfused", 1.0, source="heuristic")
    assert at.resolve_auto(cp, 1, table=t) == ("torch-unfused", None,
                                               "heuristic")
    t.record(key, 1, "torch-fused", 1.0)
    assert at.resolve_auto(cp, 1, table=t) == ("torch-fused", None,
                                               "measured")
    assert at.resolve_auto(cp, 1, faults=object(), table=t) == \
        ("torch", None, "faults")


def test_tunings_file_is_the_ports_own(tmp_path, monkeypatch):
    assert at.TUNINGS_ENV != ref_at.TUNINGS_ENV
    monkeypatch.setenv(ref_at.TUNINGS_ENV, str(tmp_path / "ref.json"))
    monkeypatch.setenv(at.TUNINGS_ENV, str(tmp_path / "port.json"))
    at.reset_default_table()
    try:
        t = at.get_default_table()
        assert t.path == tmp_path / "port.json"
        assert at.get_default_table() is t
        monkeypatch.delenv(at.TUNINGS_ENV)
        assert at.get_default_table().path is None
    finally:
        at.reset_default_table()


def test_heuristic_and_candidates():
    plans = _plans(_Port)
    # traces the kernels compute: kernels
    for kind in ("binary_matvec", "matvec", "conv"):
        cp = plans[kind].compile()
        assert at.heuristic(cp, 1) == ("kernels", None), kind
        assert ("kernels", None) in at.candidates(cp, 40)
    # over the f32 bound, or no kernel at all: fused, else per-cycle replay
    for kind in ("matvec16", "binary_conv"):
        plan = plans[kind]
        assert at.heuristic(plan.compile(), 1) == ("torch-fused", None)
        assert at.heuristic(plan.compile(fuse=False), 1) == \
            ("torch-unfused", None)
        assert all(be != "kernels" for be, _ in
                   at.candidates(plan.compile(), 40))
    cp = plans["binary_matvec"].compile()
    assert at.candidates(cp, 4, cheap=True) == [("torch-fused", None),
                                                ("kernels", None)]
    assert at.candidates(cp, 40) == [
        ("torch-fused", None), ("torch-unfused", None),
        ("torch-fused", 32), ("torch-unfused", 32), ("kernels", None)]


def test_execute_auto_labels():
    plan, mem, want = _bmv()
    cp = plan.compile()
    t = at.TuningTable()
    torch_res = execute(cp, mem, backend="torch", device="cpu")
    res = execute(cp, mem, backend="auto", device="cpu", tunings=t)
    assert res.backend == "auto:kernels"
    for decode in (plan.decode_y, plan.decode_popcount):
        np.testing.assert_array_equal(decode(res.mem), decode(torch_res.mem))
    np.testing.assert_array_equal(plan.decode_y(res.mem), want)
    key, B = at.program_key(cp), 40
    t.record(key, at.batch_bucket(B), "torch-unfused", 5.0,
             max_batch=at.CHUNK_BATCH)
    mems = np.broadcast_to(mem, (B,) + mem.shape).copy()
    res = execute(cp, mems, backend="auto", device="cpu", tunings=t)
    assert res.backend == f"auto:torch-unfused@{at.CHUNK_BATCH}"
    for b in (0, B - 1):
        np.testing.assert_array_equal(plan.decode_y(res.mem[b]), want)
    # a measured kernels row for a trace the kernels cannot compute keeps
    # the fallback's own label
    bconv = _plans(_Port)["binary_conv"]
    bcp = bconv.compile()
    t.record(at.program_key(bcp), 1, "kernels", 1.0)
    bmem = np.zeros((64, 256), np.uint8)
    res = execute(bcp, bmem, backend="auto", device="cpu", tunings=t)
    assert res.backend == "kernels:fallback-torch"


def test_autotune_execute_records_the_winner(tmp_path):
    plan, mem, want = _bmv()
    cp = plan.compile()
    t = at.TuningTable(tmp_path / "t.json")
    mems = np.broadcast_to(mem, (4,) + mem.shape).copy()
    res, entry = at.autotune_execute(cp, mems, t, reps=1, device="cpu")
    assert t.lookup(at.program_key(cp), 1) is entry
    assert entry.source == "measured" and entry.us > 0
    assert (entry.backend, entry.max_batch) in at.candidates(cp, 4,
                                                             cheap=True)
    assert (tmp_path / "t.json").exists()
    for b in range(4):
        np.testing.assert_array_equal(plan.decode_y(res.mem[b]), want)


def test_service_auto_matches_reference(tmp_path):
    """Cold pairs tune inline (labelled ``auto:<winner>``), warm pairs run
    the table's choice; every ticket equals the reference service's."""
    rng = np.random.default_rng(7)
    reqs = [("binary_matvec", (rng.choice([-1, 1], size=(6, 20)),
                               rng.choice([-1, 1], size=20))),
            ("matvec", (rng.integers(0, 16, size=(5, 12)),
                        rng.integers(0, 16, size=12), 4)),
            ("binary_conv", (rng.choice([-1, 1], size=(10, 30)),
                             rng.choice([-1, 1], size=(3, 3))))]
    ref = RefService(store=False, **GEOM)
    ref_t = [ref.submit(kind, *args) for kind, args in reqs]
    ref.flush()
    table = at.TuningTable(tmp_path / "svc.json")
    svc = PlanService(backend="auto", tunings=table, device="cpu", **GEOM)
    for round_ in ("cold", "warm"):
        mine = [svc.submit(kind, *args) for kind, args in reqs]
        svc.flush()
        for t, r in zip(mine, ref_t):
            np.testing.assert_array_equal(t.result, r.result)
            assert (t.cycles, t.n_units) == (r.cycles, r.n_units)
            assert t.backend.startswith("auto:"), (round_, t.backend)
        assert len(table) == 3
    assert at.TuningTable(tmp_path / "svc.json").entries().keys() == \
        table.entries().keys()
    assert svc.stats.hits + svc.stats.misses == svc.stats.requests == 6
