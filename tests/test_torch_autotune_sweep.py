"""The port's offline tuning sweep (``tools/autotune_torch.py``) on the CPU.

* ``--quick --device cpu`` writes a tunings table that the port reads:
  every quick workload's (program key, batch bucket) resolves to a
  ``measured`` entry, and ``execute(backend="auto")`` under
  ``$MATPIM_TORCH_TUNINGS`` runs the table's winner: its label and final
  images are the winner's.
* ``service_work`` captures the buckets one ``PlanService`` flush
  executes; after ``sweep`` over them, a fresh ``PlanService(
  backend="auto")`` on that table flushes the same requests without
  tuning any bucket inline (the ``serve.inline_tunes`` counter does not
  move), with every ticket equal to the kernels service's and labelled
  ``auto:<winner>``.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.core import execute  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serve import PlanService  # noqa: E402

_TOOL = Path(__file__).resolve().parent.parent / "tools" / "autotune_torch.py"
_spec = importlib.util.spec_from_file_location("autotune_torch", _TOOL)
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

GEOM = dict(rows=64, cols=256, parts=8)


def test_quick_table_is_served_by_auto(tmp_path, monkeypatch):
    out = tmp_path / "tunings.json"
    assert tool.main(["--quick", "--device", "cpu", "--batches", "8",
                      "--reps", "1", "--out", str(out)]) == 0
    table = at.TuningTable(out)
    assert table.load_error is None and len(table) == 2
    monkeypatch.setenv(at.TUNINGS_ENV, str(out))
    at.reset_default_table()
    try:
        for name, plan, mems in tool.batched(tool.workloads(True), [8]):
            cp = plan.compile()
            be, mb, source = at.resolve_auto(cp, 8, table=table)
            assert source == "measured", name
            got = execute(cp, mems, backend="auto", device="cpu")
            want = execute(cp, mems, backend=be, max_batch=mb, device="cpu")
            assert got.backend.startswith(f"auto:{be}"), got.backend
            np.testing.assert_array_equal(got.mem, want.mem)
    finally:
        at.reset_default_table()


def _requests(rng):
    return [("binary_matvec", (rng.choice([-1, 1], size=(6, 20)),
                               rng.choice([-1, 1], size=20))),
            ("binary_matvec", (rng.choice([-1, 1], size=(9, 20)),
                               rng.choice([-1, 1], size=20))),
            ("matvec", (rng.integers(0, 16, size=(5, 12)),
                        rng.integers(0, 16, size=12), 4)),
            ("binary_conv", (rng.choice([-1, 1], size=(10, 30)),
                             rng.choice([-1, 1], size=(3, 3))))]


def test_sweep_leaves_nothing_to_tune_inline(tmp_path):
    work = tool.service_work(_requests(np.random.default_rng(7)),
                             device="cpu", **GEOM)
    assert len(work) >= 3
    table = at.TuningTable(tmp_path / "svc.json")
    tuned = tool.sweep(work, table, device="cpu", reps=1, log=None)
    assert len(tuned) == len(work) and len(table) >= 3

    reqs = _requests(np.random.default_rng(7))
    plain = PlanService(backend="kernels", store=False, device="cpu", **GEOM)
    want = [plain.submit(kind, *args) for kind, args in reqs]
    plain.flush()
    inline = metrics.counter("serve.inline_tunes")
    before = inline.value
    svc = PlanService(backend="auto", store=False, device="cpu",
                      tunings=at.TuningTable(tmp_path / "svc.json"), **GEOM)
    got = [svc.submit(kind, *args) for kind, args in reqs]
    svc.flush()
    assert inline.value == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result, w.result)
        assert g.backend.startswith("auto:"), g.backend
