"""Multi-device tile execution in the port against the reference.

``repro_torch.distributed`` must resolve placements as the reference does
(``chunk_widths``, ``resolve_spec``), and mapping the engine's tile batch
over a ``("tiles",)`` mesh must change where chunks run, never what they
compute: all four plan kinds on eight CPU slots (``tile_mesh(devices=
["cpu"] * 8)``, the counterpart of the reference's eight virtual XLA
devices) give the single-device bits and the reference's
``backend="numpy"`` bits, labelled ``+mesh8``. Fault runs, batches
smaller than the mesh and one-slot meshes fall back silently. A shuffled
heterogeneous stream on ``PlanService(devices=4)`` gives the serial
service's and the reference service's tickets.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from jax.sharding import PartitionSpec as P  # noqa: E402
from repro.core.tiling import TiledBinaryMatvec as RefTiledBinaryMatvec  # noqa
from repro.core.tiling import TiledConv2d as RefTiledConv2d  # noqa: E402
from repro.core.tiling import TiledMatvec as RefTiledMatvec  # noqa: E402
from repro.distributed import mesh_exec as ref_mesh_exec  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.serve.matpim import PlanService as RefService  # noqa: E402
from repro.serve.matpim import ServeRequest as RefRequest  # noqa: E402
from repro_torch.core import autotune as at  # noqa: E402
from repro_torch.core.tiling import (TiledBinaryMatvec, TiledConv2d,  # noqa
                                     TiledMatvec)
from repro_torch.device.faults import FaultModel, FaultRealization  # noqa
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.mesh_exec import (chunk_widths,  # noqa: E402
                                               mesh_devices, tile_mesh,
                                               try_run_sharded)
from repro_torch.distributed.sharding import (PARAM_RULES, RULES,  # noqa
                                              Mesh, constrain, resolve_spec,
                                              tree_shardings, use_mesh)
from repro_torch.serve import PlanService, ServeRequest  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
CPU8 = ["cpu"] * 8


class FakeMesh:
    """Duck-typed mesh: axis names and a shape mapping, no devices (the
    reference's ``tests/test_sharding.py`` fixture)."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                  np.asarray(b, dtype=object))


# ---------------------------------------------------------------------------
# Placement: the reference's host logic, letter for letter
# ---------------------------------------------------------------------------


def test_chunk_widths_equal_reference():
    for B in (1, 2, 7, 8, 9, 20, 31, 32, 33, 64, 100, 255, 256, 300, 1000):
        for D in (1, 2, 3, 4, 5, 8, 16):
            if B < D:
                with pytest.raises(ValueError):
                    chunk_widths(B, D)
                with pytest.raises(ValueError):
                    ref_mesh_exec.chunk_widths(B, D)
                continue
            assert chunk_widths(B, D) == ref_mesh_exec.chunk_widths(B, D)
    assert chunk_widths(20, 8) == [3, 3, 3, 3, 2, 2, 2, 2]


def test_rules_equal_reference():
    assert RULES == ref_sharding.RULES
    assert PARAM_RULES == ref_sharding.PARAM_RULES


@pytest.mark.parametrize("axes,shape,mesh,rules", [
    (("embed", "heads", "head_dim"), (4096, 32, 128), MESH, RULES),
    (("embed", "heads", "head_dim"), (384, 6, 64), MESH, RULES),
    (("experts", "embed", "mlp"), (128, 7168, 4864), MESH, RULES),
    (("embed", "mlp"), (4096, 16384), MESH, PARAM_RULES),
    (("batch", None), (256, 4096), MESH3, RULES),
    (("batch", None), (256, 4096), MESH, RULES),
    (("layers", "batch", "cache_seq", "kv_heads", None),
     (60, 128, 32768, 8, 128), MESH, RULES),
    (("vocab", "embed"), (200192, 3072), MESH, RULES),
    (("tiles", None, None), (16, 257, 65), FakeMesh({"tiles": 8}),
     {"tiles": "tiles"}),
    (("tiles", None, None), (12, 257, 65), FakeMesh({"tiles": 8}),
     {"tiles": "tiles"}),
])
def test_resolve_spec_equals_reference(axes, shape, mesh, rules):
    got = resolve_spec(axes, shape, mesh, rules)
    want = ref_sharding.resolve_spec(axes, shape, mesh, rules)
    assert isinstance(got, tuple) and len(got) == len(shape)
    assert P(*got) == want       # PartitionSpec equates ("data",) and "data"


def test_resolve_spec_reads_the_ambient_rules():
    mesh = tile_mesh(devices=["cpu"] * 4)
    with use_mesh(mesh, rules={"batch": "tiles"}):
        assert sharding.current_mesh() is mesh
        assert resolve_spec(("batch", None), (8, 3), mesh) == ("tiles", None)
    assert sharding.current_mesh() is None
    assert resolve_spec(("batch", None), (8, 3), mesh) == (None, None)


def test_constrain_identity_or_refusal():
    x = torch.zeros(8, 6, 4)
    axes = ("batch", "heads", None)
    assert constrain(x, axes) is x                       # no mesh
    one = Mesh(["cpu"], ("data", "model"), {"data": 1, "model": 1})
    with use_mesh(one):
        assert constrain(x, axes) is x                   # splits nothing
    with use_mesh(tile_mesh(devices=CPU8)):
        assert constrain(x, axes) is x                   # tiles only
    # a mesh with no process group cannot split a tensor: the DTensor
    # path (tests/test_torch_dist.py) needs the group's DeviceMesh
    tp = Mesh(["cpu"] * 2, ("data", "model"), {"data": 1, "model": 2})
    with use_mesh(tp):
        with pytest.raises(ValueError, match="no process group"):
            constrain(x, axes)
        # an indivisible dim replicates: nothing is split
        assert constrain(torch.zeros(8, 3, 4), axes).shape == (8, 3, 4)


def test_mesh_and_tree_shardings():
    with pytest.raises(ValueError):
        Mesh(["cpu"] * 3, ("data", "model"), {"data": 2, "model": 2})
    with pytest.raises(ValueError):
        tile_mesh(devices=[])
    mesh = Mesh(["cpu"] * 4, ("data", "model"), {"data": 2, "model": 2})
    axes = {"w": ("embed", "mlp"), "b": ("mlp",), "n": {"g": (None,)}}
    arrs = {"w": torch.zeros(4, 6), "b": torch.zeros(6),
            "n": {"g": torch.zeros(3)}}
    sh = tree_shardings(axes, arrs, mesh, params=True)
    assert sh["w"].spec == ("data", "model") and sh["w"].mesh is mesh
    assert sh["b"].spec == ("model",) and sh["n"]["g"].spec == (None,)
    assert tree_shardings(axes, arrs, mesh)["w"].spec == (None, "model")


def test_tile_mesh_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tile_mesh()
    m = tile_mesh(3, devices=CPU8)
    assert (m.size, m.axis_names, mesh_devices(m)) == (3, ("tiles",), 3)
    assert mesh_devices(object()) == 1


# ---------------------------------------------------------------------------
# Eight CPU slots: every plan kind bit-identical (the reference's cases)
# ---------------------------------------------------------------------------


def _wrappers(port: bool):
    """The reference's ``_wrappers``: one tiled wrapper and operands per
    plan kind, each with at least 8 tiles."""
    bmv, mv, conv = ((TiledBinaryMatvec, TiledMatvec, TiledConv2d) if port
                     else (RefTiledBinaryMatvec, RefTiledMatvec,
                           RefTiledConv2d))
    rng = np.random.default_rng(11)
    out = {}
    t = bmv(256, 416, **GEOM)                          # 4 x 4 = 16 tiles
    out["binary_matvec"] = (t, (rng.choice([-1, 1], size=(256, 416)),
                                rng.choice([-1, 1], size=416)))
    t = mv(128, 72, 4, **GEOM)                         # 2 x 4 = 8 tiles
    out["matvec"] = (t, (rng.integers(0, 16, size=(128, 72)),
                         rng.integers(0, 16, size=72)))
    t = conv(14, 26, 3, 4, tile_m=8, tile_n=8, **GEOM)   # 8 tiles
    out["conv"] = (t, (rng.integers(0, 16, size=(14, 26)),
                       rng.integers(0, 16, size=(3, 3))))
    t = conv(14, 26, 3, 1, tile_m=8, tile_n=8, binary=True,
             **GEOM)                                   # 8 tiles
    out["binary_conv"] = (t, (rng.choice([-1, 1], size=(14, 26)),
                              rng.choice([-1, 1], size=(3, 3))))
    return out


@pytest.mark.parametrize("kind", ["binary_matvec", "matvec", "conv",
                                  "binary_conv"])
def test_all_kinds_bit_identical_on_8_devices(kind):
    t, ops = _wrappers(port=True)[kind]
    ref, ref_ops = _wrappers(port=False)[kind]
    assert t.n_tiles >= 8
    y0, r0 = t.run(*ops, backend="torch", device="cpu")
    y1, r1 = t.run(*ops, backend="torch", device="cpu",
                   mesh=tile_mesh(devices=CPU8))
    yr, rr = ref.run(*ref_ops, backend="numpy")
    assert "+mesh" not in r0.backend
    assert r1.backend == "torch+mesh8", r1.backend
    _same(y1, y0)
    _same(y1, yr)
    assert r0.cycles == r1.cycles == rr.cycles


@pytest.mark.parametrize("variant", ["fused", "unfused"])
@pytest.mark.parametrize("B,D", [(8, 8), (20, 8), (33, 4), (100, 3)])
def test_sharded_engine_equals_single_device(B, D, variant):
    """``try_run_sharded`` packs the reference's chunks; any split of the
    batch over the slots gives the one-device memory image."""
    t = TiledBinaryMatvec(64, 416, **GEOM)
    cp = t.plan.compile()
    rng = np.random.default_rng(B * D)
    mems = (rng.random((B, t.plan.rows, t.plan.cols)) < 0.5).astype(np.uint8)
    want = t.plan.execute_batch(mems, backend=f"torch-{variant}",
                                device="cpu").mem
    out, d, n = try_run_sharded(cp, mems, variant, tile_mesh(D, CPU8))
    assert (d, n) == (D, len(chunk_widths(B, D)))
    np.testing.assert_array_equal(out, want)


def test_ambient_mesh_via_use_mesh():
    t, (A, x) = _wrappers(port=True)["binary_matvec"]
    y0, _ = t.run(A, x, backend="torch", device="cpu")
    with use_mesh(tile_mesh(devices=CPU8)):
        y1, r1 = t.run(A, x, backend="torch", device="cpu")
    assert r1.backend.endswith("+mesh8")
    np.testing.assert_array_equal(y0, y1)
    # the mesh deactivates with the context: back to the one-device label
    _, r2 = t.run(A, x, backend="torch", device="cpu")
    assert "+mesh" not in r2.backend


def test_fallbacks_are_silent_and_bit_identical():
    """Faults, a batch smaller than the mesh, one slot and ``kernels`` run
    the single-device path, with its bits and label."""
    mesh = tile_mesh(devices=CPU8)
    t, (A, x) = _wrappers(port=True)["binary_matvec"]
    cp = t.plan.compile()
    real = FaultRealization.sample(
        FaultModel(p_sa0=0.002, p_sa1=0.001), t.n_tiles, t.plan.rows,
        t.plan.cols, cp.n_cycles, cp.W, cp.I, rng=42)
    y0, r0 = t.run(A, x, backend="torch", device="cpu", faults=real)
    y1, r1 = t.run(A, x, backend="torch", device="cpu", faults=real,
                   mesh=mesh)
    assert "+mesh" not in r1.backend
    np.testing.assert_array_equal(y0, y1)
    fm = FaultModel(p_sa0=0.002)
    yf0, _ = t.run(A, x, backend="torch", device="cpu", faults=fm, rng=7)
    yf1, rf1 = t.run(A, x, backend="torch", device="cpu", faults=fm, rng=7,
                     mesh=mesh)
    assert "+mesh" not in rf1.backend
    np.testing.assert_array_equal(yf0, yf1)
    small = TiledBinaryMatvec(64, 416, **GEOM)          # 4 tiles < 8 slots
    rng = np.random.default_rng(3)
    A4, x4 = rng.choice([-1, 1], size=(64, 416)), rng.choice([-1, 1], 416)
    ys, rs = small.run(A4, x4, backend="torch", device="cpu", mesh=mesh)
    assert rs.backend == "torch"
    np.testing.assert_array_equal(
        ys, small.run(A4, x4, backend="torch", device="cpu")[0])
    one = tile_mesh(1, devices=CPU8)
    assert try_run_sharded(cp, np.zeros((8, 64, 256), np.uint8), "fused",
                           one) is None
    y2, r2 = t.run(A, x, backend="torch", device="cpu", mesh=one)
    assert r2.backend == "torch"
    np.testing.assert_array_equal(y2, t.run(A, x, backend="torch",
                                            device="cpu")[0])
    yk, rk = t.run(A, x, backend="kernels", device="cpu", mesh=mesh)
    assert rk.backend == "kernels"
    np.testing.assert_array_equal(yk, y2)


def test_auto_backend_resolves_through_mesh_topology():
    """``backend="auto"`` under a mesh keys its lookup by topology: a
    1-device measured entry does not decide the 8-slot execute, and the
    heuristic picks the family that shards."""
    t, (A, x) = _wrappers(port=True)["binary_matvec"]
    cp = t.plan.compile()
    table = at.TuningTable()
    key, bucket = at.program_key(cp), at.batch_bucket(t.n_tiles)
    table.record(key, bucket, "kernels", 123.0)         # topo 1, measured
    assert at.resolve_auto(cp, t.n_tiles, table=table)[0] == "kernels"
    be, mb, src = at.resolve_auto(cp, t.n_tiles, table=table, topo=8)
    assert (be, mb, src) == ("torch-fused", None, "heuristic")
    assert at.heuristic(cp, t.n_tiles, topo=8) == ("torch-fused", None)
    y1, r1 = t.run(A, x, backend="auto", device="cpu",
                   mesh=tile_mesh(devices=CPU8))
    assert r1.backend == "auto:torch-fused+mesh8", r1.backend
    np.testing.assert_array_equal(
        y1, t.run(A, x, backend="torch", device="cpu")[0])


def test_auto_service_trains_the_mesh_topology():
    """A service on ``backend="auto"`` under an ambient mesh parses the
    label ``auto:<b>[@mb]+mesh<D>`` and records its wall at topo D."""
    table = at.TuningTable()
    svc = PlanService(backend="auto", device="cpu", tunings=table,
                      autotune=False, **GEOM)
    rng = np.random.default_rng(4)
    A, x = rng.choice([-1, 1], size=(256, 416)), rng.choice([-1, 1], 416)
    with use_mesh(tile_mesh(devices=CPU8)):
        t = svc.submit_binary_matvec(A, x)
        svc.flush()
    assert t.backend == "auto:torch-fused+mesh8", t.backend
    np.testing.assert_array_equal(t.result, np.where(A @ x >= 0, 1, -1))
    cp = svc._plans[t.key].plan.compile()
    e = table.lookup(at.program_key(cp), at.batch_bucket(t.n_units), topo=8)
    assert e is not None and e.backend == "torch-fused"
    assert table.lookup(at.program_key(cp), at.batch_bucket(t.n_units)) \
        is None


# ---------------------------------------------------------------------------
# Serving layer: bucket dispatch over device slots vs the serial loop
# ---------------------------------------------------------------------------


def _mixed_stream(rng, n=24):
    """The reference's ``_mixed_stream``, as (kind, args) pairs."""
    reqs = []
    for i in range(n):
        pick = i % 4
        if pick == 0:
            m, k = int(rng.integers(2, 20)), int(rng.integers(4, 40))
            reqs.append(("binary_matvec",
                         (rng.choice([-1, 1], size=(m, k)),
                          rng.choice([-1, 1], size=k))))
        elif pick == 1:
            m, k = int(rng.integers(2, 12)), int(rng.integers(2, 10))
            reqs.append(("matvec", (rng.integers(0, 16, size=(m, k)),
                                    rng.integers(0, 16, size=k), 4)))
        elif pick == 2:
            h, w = int(rng.integers(6, 14)), int(rng.integers(6, 14))
            reqs.append(("conv", (rng.integers(0, 16, size=(h, w)),
                                  rng.integers(0, 8, size=(3, 3)), 6)))
        else:
            h, w = int(rng.integers(6, 14)), int(rng.integers(6, 14))
            reqs.append(("binary_conv",
                         (rng.choice([-1, 1], size=(h, w)),
                          rng.choice([-1, 1], size=(3, 3)))))
    perm = rng.permutation(len(reqs))
    return [reqs[int(i)] for i in perm]


@pytest.fixture(scope="module")
def ref_stream():
    """The mixed stream and the reference service's tickets for it."""
    reqs = _mixed_stream(np.random.default_rng(21))
    ref = RefService(**GEOM)
    return reqs, ref.run_stream([RefRequest(k, a) for k, a in reqs],
                                slots=48)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_stream_multi_device_dispatch_bit_identical(backend, ref_stream):
    """A shuffled heterogeneous stream served with devices=4 (overlapped
    buckets) gives per-ticket results equal to the serial loop's and the
    reference service's."""
    reqs, t_ref = ref_stream
    serial = PlanService(backend=backend, device="cpu", **GEOM)
    t_serial = serial.run_stream([ServeRequest(k, a) for k, a in reqs],
                                 slots=48)
    par = PlanService(backend=backend, device="cpu", devices=4, **GEOM)
    try:
        t_par = par.run_stream([ServeRequest(k, a) for k, a in reqs],
                               slots=48)
        assert par.devices == 4
        assert len(t_par) == len(t_serial) == len(t_ref) == len(reqs)
        for r, a, b in zip(t_ref, t_serial, t_par):
            assert r.kind == a.kind == b.kind and b.done
            _same(b.result, a.result)
            _same(b.result, r.result)
            assert r.cycles == a.cycles == b.cycles
        assert {t.device for t in t_par} <= set(range(4))
        assert len({t.device for t in t_par}) > 1     # slots overlapped
        s = par.stats
        assert s.hits + s.misses == s.requests == len(reqs)
        assert s.units == sum(t.n_units for t in t_par)
    finally:
        par.close()
    assert par._exec_pool is None


def test_flush_multi_device_matches_submit_order_results():
    rng = np.random.default_rng(5)
    svc = PlanService(device="cpu", devices=3, **GEOM)
    try:
        pairs = []
        for _ in range(9):
            m, k = int(rng.integers(2, 30)), int(rng.integers(4, 60))
            A = rng.choice([-1, 1], size=(m, k))
            x = rng.choice([-1, 1], size=k)
            pairs.append(((A, x), svc.submit_binary_matvec(A, x)))
        done = svc.flush()
        assert len(done) == 9 and all(t.done for t in done)
        for (A, x), t in pairs:
            np.testing.assert_array_equal(t.result,
                                          np.where(A @ x >= 0, 1, -1))
    finally:
        svc.close()


def test_fault_model_buckets_stay_serial():
    """Fault-model buckets draw from the service's one stream in order:
    the same seed gives the serial service's bits with devices=4."""
    fm = FaultModel(p_sa0=0.01, p_switch=0.01)
    rng = np.random.default_rng(8)
    reqs = [(rng.choice([-1, 1], size=(int(rng.integers(4, 40)), k)),
             rng.choice([-1, 1], size=k))
            for k in (20, 40, 70, 100, 150, 200)]

    def serve(devices):
        svc = PlanService(device="cpu", devices=devices, seed=3, **GEOM)
        try:
            ts = [svc.submit_binary_matvec(A, x, faults=fm if i % 2 else
                                           None)
                  for i, (A, x) in enumerate(reqs)]
            svc.flush()
            return [t.result for t in ts]
        finally:
            svc.close()

    for a, b in zip(serve(1), serve(4)):
        np.testing.assert_array_equal(a, b)


def _fault_stream(rng, n=12):
    return [(rng.choice([-1, 1], size=(int(rng.integers(4, 40)), k)),
             rng.choice([-1, 1], size=k), i % 2 == 1)
            for i, k in enumerate(rng.integers(8, 200, size=n))]


def _two_threads(target):
    import sys
    import threading
    errors = []

    def run(mode):
        try:
            target(mode)
        except Exception as e:    # surfaced below, with the thread's error
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(m,))
                   for m in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors


@pytest.mark.parametrize("call", ["flush", "step"])
def test_concurrent_callers_keep_seeded_fault_bits_on_one_slot(call):
    """Two threads serve one seeded ``devices=1`` service at once, both
    flushing or both stepping: one slot serialises whole calls, so every
    ticket carries the bits of the same calls made from one thread,
    FaultModel draws included."""
    fm = FaultModel(p_sa0=0.01, p_switch=0.01)
    reqs = _fault_stream(np.random.default_rng(12))

    def serve(threads):
        svc = PlanService(device="cpu", devices=1, seed=4, **GEOM)
        try:
            ts = [svc.submit_binary_matvec(A, x, faults=fm if f else None)
                  for A, x, f in reqs]

            def drain(_):
                if call == "flush":
                    svc.flush()
                while call == "step" and svc.pending_units:
                    svc.step()

            if threads:
                _two_threads(drain)
            else:
                drain(None)
            assert all(t.done for t in ts)
            return [t.result for t in ts]
        finally:
            svc.close()

    for a, b in zip(serve(False), serve(True)):
        np.testing.assert_array_equal(a, b)


def test_concurrent_flush_and_step_serve_each_request_once():
    """One thread flushes and one steps a ``devices=2`` service at once:
    ``step`` drops buckets a flush claimed since it grouped them, so no
    bucket runs twice, and the ideal requests equal their oracle."""
    fm = FaultModel(p_sa0=0.01, p_switch=0.01)
    reqs = _fault_stream(np.random.default_rng(13), n=16)
    svc = PlanService(device="cpu", devices=2, seed=4, **GEOM)
    try:
        ts = [svc.submit_binary_matvec(A, x, faults=fm if f else None)
              for A, x, f in reqs]

        def drain(mode):
            if mode == "a":
                svc.flush()
            while mode == "b" and svc.pending_units:
                svc.step()

        _two_threads(drain)
        assert all(t.done for t in ts) and not svc.pending_units
        # one engine batch per exec key: no bucket ran twice
        assert svc.stats.batches == len({(t.key, f)
                                         for t, (_, _, f) in zip(ts, reqs)})
        for t, (A, x, f) in zip(ts, reqs):
            if not f:
                np.testing.assert_array_equal(t.result,
                                              np.where(A @ x >= 0, 1, -1))
    finally:
        svc.close()
    # the window, made deterministic: buckets grouped before another
    # caller's flush served them are dropped by the step, not rerun
    svc = PlanService(device="cpu", devices=2, **GEOM)
    try:
        (A, x, _), (A2, x2, _) = reqs[:2]
        svc.submit_binary_matvec(A, x)
        stale = svc._next_buckets()
        svc.flush()
        later = svc.submit_binary_matvec(A2, x2)
        svc._next_buckets = lambda: stale
        assert svc.step() == [] and svc.stats.batches == 1
        del svc._next_buckets
        assert svc.step() == [later] and later.done
    finally:
        svc.close()


@pytest.mark.parametrize("module", [
    "repro_torch.distributed.sharding", "repro_torch.distributed.mesh_exec",
    "repro_torch.models.spec"])
def test_docstring_examples(module):
    """The examples in the slice's new modules run on the CPU as written."""
    import doctest
    import importlib
    res = doctest.testmod(importlib.import_module(module))
    assert res.attempted > 0 and res.failed == 0


def test_concurrent_flushes_under_thread_stress():
    """Two threads flush one ``devices=8`` service at once with a short
    switch interval: every request is served exactly once (claims keep a
    bucket from running twice) and the counters add up."""
    import sys
    import threading
    rng = np.random.default_rng(9)
    svc = PlanService(device="cpu", devices=8, **GEOM)
    pairs = []
    for _ in range(24):
        m, k = int(rng.integers(2, 40)), int(rng.integers(4, 70))
        A, x = rng.choice([-1, 1], size=(m, k)), rng.choice([-1, 1], size=k)
        pairs.append(((A, x), svc.submit_binary_matvec(A, x)))
    n_buckets = len({t.key for _, t in pairs})
    done, errors = [], []

    def flush():
        try:
            done.extend(svc.flush())
        except Exception as e:    # surfaced below, with the thread's error
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=flush) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert not errors, errors
    assert sorted(t.uid for t in done) == sorted(t.uid for _, t in pairs)
    for (A, x), t in pairs:
        assert t.done
        np.testing.assert_array_equal(t.result, np.where(A @ x >= 0, 1, -1))
    assert svc.stats.batches == n_buckets
    assert svc.stats.units == sum(t.n_units for _, t in pairs)
