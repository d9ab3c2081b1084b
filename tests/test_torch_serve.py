"""Tiling and serving in the port against the reference.

``TiledBinaryMatvec`` and ``PlanService`` (``repro_torch``) must give the
reference's results exactly: the same ``y``, popcounts, grid, cycles and
reduction depth for tiled products, and the same tickets for a shuffled
binary stream served through ``submit``/``flush`` and ``run_stream``. Small
geometries on the CPU (``device="cpu"``); full width is ``chip_smoke.py``'s.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro.core.tiling import TiledBinaryMatvec as RefTiled  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro.serve.matpim import ServeRequest as RefRequest  # noqa: E402
from repro_torch.core import TiledBinaryMatvec  # noqa: E402
from repro_torch.core.autotune import TuningTable  # noqa: E402
from repro_torch.core.tiling import majority_sign, tree_reduce  # noqa: E402
from repro_torch.device.faults import FaultModel  # noqa: E402
from repro_torch.serve import PlanService, ServeRequest  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)


@pytest.mark.parametrize("M,K,backend", [(100, 200, "torch"),
                                         (64, 104, "kernels"),
                                         (130, 330, "kernels"),
                                         (40, 96, "torch-unfused")])
def test_tiled_binary_matvec_matches_reference(M, K, backend):
    rng = np.random.default_rng(M + K)
    A = rng.choice([-1, 1], size=(M, K))
    x = rng.choice([-1, 1], size=K)
    ref = RefTiled(M, K, **GEOM)
    y_ref, info_ref = ref.run(A, x, backend="numpy")
    t = TiledBinaryMatvec(M, K, **GEOM)
    y, info = t.run(A, x, backend=backend, device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(y, np.where(A @ x >= 0, 1, -1))
    np.testing.assert_array_equal(t.last_popcounts, ref.last_popcounts)
    assert (info.grid, info.n_tiles, info.cycles, info.reduce_depth) == \
        (info_ref.grid, info_ref.n_tiles, info_ref.cycles,
         info_ref.reduce_depth)
    assert info.backend == backend


def test_tree_reduce_and_majority_sign_match_reference():
    from repro.core.tiling import majority_sign as ref_sign
    from repro.core.tiling import tree_reduce as ref_reduce
    rng = np.random.default_rng(3)
    for n in (1, 2, 5, 8):
        parts = [rng.integers(0, 100, size=6) for _ in range(n)]
        got, want = tree_reduce(parts), ref_reduce(parts)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    pop = rng.integers(0, 33, size=40)
    for k in (31, 32):
        np.testing.assert_array_equal(majority_sign(pop, k),
                                      ref_sign(pop, k))


def _stream(seed, n=10):
    rng = np.random.default_rng(seed)
    shapes = [(3, 10), (8, 20), (5, 9), (40, 100), (64, 104), (2, 17),
              (9, 33)]
    reqs = []
    for i in range(n):
        m, k = shapes[rng.integers(len(shapes))]
        reqs.append((rng.choice([-1, 1], size=(m, k)),
                     rng.choice([-1, 1], size=k)))
    rng.shuffle(reqs)
    return reqs


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_plan_service_flush_matches_reference(backend):
    reqs = _stream(11)
    ref = RefService(store=False, **GEOM)
    ref_t = [ref.submit_binary_matvec(A, x) for A, x in reqs]
    ref.flush()
    svc = PlanService(store=False, backend=backend, device="cpu", **GEOM)
    mine = [svc.submit_binary_matvec(A, x) for A, x in reqs]
    done = svc.flush()
    assert len(done) == len(reqs) and all(t.done for t in mine)
    for t, r, (A, x) in zip(mine, ref_t, reqs):
        np.testing.assert_array_equal(t.result, r.result)
        np.testing.assert_array_equal(t.result, np.where(A @ x >= 0, 1, -1))
        assert (t.key[:3], t.cycles, t.reduce_depth, t.n_units) == \
            (r.key[:3], r.cycles, r.reduce_depth, r.n_units)
        assert t.backend == backend
    for f in ("hits", "misses", "requests", "batches", "units"):
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f


def test_run_stream_matches_reference():
    reqs = _stream(5, n=14)
    ref = RefService(store=False, max_plans=2, **GEOM)
    want = ref.run_stream([RefRequest("binary_matvec", r) for r in reqs],
                          slots=8)
    svc = PlanService(store=False, max_plans=2, backend="kernels",
                      device="cpu", **GEOM)
    got = svc.run_stream([ServeRequest("binary_matvec", r) for r in reqs],
                         slots=8)
    assert len(got) == len(want) == len(reqs)
    for t, r in zip(got, want):
        np.testing.assert_array_equal(t.result, r.result)
        assert (t.cycles, t.queue_steps, t.batch_units) == \
            (r.cycles, r.queue_steps, r.batch_units)
    for f in ("hits", "misses", "evictions", "batches", "units"):
        assert getattr(svc.stats, f) == getattr(ref.stats, f), f


def test_service_rejects_what_is_not_ported(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PlanService(**GEOM)              # default device is CUDA
    with pytest.raises(NotImplementedError, match="mesh_exec"):
        PlanService(device="cpu", devices=2, **GEOM)
    with pytest.raises(ValueError):
        PlanService(device="cpu", backend="numpy", **GEOM)
    # ported since: the autotuner, the compile pool and the plan store
    A, x = np.ones((3, 10), dtype=int), np.ones(10, dtype=int)
    for kw, label in (({"async_compile": True}, "torch"),
                      ({"store": tmp_path / "plans"}, "torch"),
                      ({"backend": "auto", "tunings": TuningTable()},
                       "auto:kernels")):
        svc = PlanService(device="cpu", **GEOM, **kw)
        t = svc.submit_binary_matvec(A, x)
        svc.flush()
        svc.close()
        assert [int(v) for v in t.result] == [1, 1, 1]
        assert t.backend == label
    svc = PlanService(device="cpu", **GEOM)
    with pytest.raises(NotImplementedError, match="device/faults.py"):
        svc.submit_binary_matvec(np.ones((2, 8)), np.ones(8),
                                 faults=FaultModel(p_switch=0.1))
