"""The port's compile pool (``repro_torch.serve.compile_pool``) and the
async admit path of its ``PlanService``.

What must hold, as in the reference: a key compiles at most once however
many submitters race (single-flight), the queue is bounded and rejects
instead of blocking (the service then compiles inline), job errors are
kept on the job, and tickets under threaded async admission are
bit-identical to a synchronous service's. The port adds one rule: a worker
thread runs host work only, so a landed plan's replay tables are built on
the thread that lands it. Every wait has its own timeout. CPU only.
"""
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # leave the other test workers their cores

from repro_torch.serve import PlanService  # noqa: E402
from repro_torch.serve import matpim as serve_matpim  # noqa: E402
from repro_torch.serve.compile_pool import CompilePool  # noqa: E402

GEOM = dict(rows=64, cols=256, parts=8)
WAIT = 30.0   # seconds any single wait may take before the test fails


def _mixed_requests(rng, n):
    reqs = []
    for i in range(n):
        m, k = int(rng.integers(2, 10)), int(rng.integers(4, 20))
        if i % 3 == 2:
            reqs.append(("binary_conv", (rng.choice([-1, 1], size=(m + 3, k)),
                                         np.ones((3, 3), int))))
        elif i % 3:
            reqs.append(("matvec", (rng.integers(0, 16, size=(m, k)),
                                    rng.integers(0, 16, size=k), 4)))
        else:
            reqs.append(("binary_matvec", (rng.choice([-1, 1], size=(m, k)),
                                           rng.choice([-1, 1], size=k))))
    return reqs


def test_pool_runs_jobs_and_drains():
    pool = CompilePool(workers=2, max_queue=8)
    try:
        jobs = [pool.submit(f"k{i}", lambda i=i: i * i) for i in range(6)]
        assert pool.drain(WAIT)
        for i, j in enumerate(jobs):
            assert j.done.is_set() and j.error is None and j.result == i * i
            assert j.wall_s >= 0 and j.finished_s >= j.started_s
        assert pool.inflight == 0
    finally:
        pool.shutdown()
    with pytest.raises(RuntimeError):
        pool.submit("late", lambda: 1)
    pool.shutdown()                       # idempotent


def test_pool_single_flight_under_racing_submitters(fast_switching):
    pool = CompilePool(workers=2, max_queue=4)
    gate, ran = threading.Event(), []
    jobs, barrier = [], threading.Barrier(8)

    def compile_once():
        gate.wait(WAIT)
        ran.append(1)
        return 42

    def submitter():
        barrier.wait(WAIT)
        jobs.append(pool.submit("key", compile_once))

    threads = [threading.Thread(target=submitter) for _ in range(8)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        assert len(jobs) == 8 and all(j is jobs[0] for j in jobs)
        assert pool.inflight == 1
        gate.set()
        assert jobs[0].wait(WAIT) and jobs[0].result == 42
        assert ran == [1], "racing submitters compiled the key twice"
        # after landing the key is free again: a new submit is a new job
        again = pool.submit("key", lambda: 7)
        assert again is not jobs[0] and again.wait(WAIT)
        assert again.result == 7
    finally:
        gate.set()
        pool.shutdown()


def test_pool_bounded_queue_rejects_when_full():
    pool = CompilePool(workers=1, max_queue=2)
    started, gate = threading.Event(), threading.Event()
    try:
        pool.submit("blocker", lambda: (started.set(), gate.wait(WAIT)))
        assert started.wait(WAIT)           # the worker holds the blocker
        fill = [pool.submit(f"fill{i}", lambda i=i: i) for i in range(2)]
        assert all(j is not None for j in fill) and pool.queue_depth == 2
        assert pool.submit("overflow", lambda: None) is None
        assert pool.inflight == 3           # the rejected key is not held
        gate.set()
        assert pool.drain(WAIT)
        late = pool.submit("late", lambda: "ok")
        assert late is not None and late.wait(WAIT) and late.result == "ok"
    finally:
        gate.set()
        pool.shutdown()


def test_pool_keeps_job_errors_on_the_job():
    pool = CompilePool(workers=1, max_queue=4)
    try:
        job = pool.submit("boom", lambda: 1 // 0)
        assert job.wait(WAIT) and isinstance(job.error, ZeroDivisionError)
        ok = pool.submit("next", lambda: 1)
        assert ok.wait(WAIT) and ok.result == 1
    finally:
        pool.shutdown()


@pytest.fixture
def compiles(monkeypatch):
    """Records the thread of every ``compile_program`` call made through
    the plans."""
    import repro_torch.core.plan as plan_mod
    calls = []
    real = plan_mod.compile_program

    def counting(*args, **kwargs):
        calls.append(threading.get_ident())
        return real(*args, **kwargs)

    monkeypatch.setattr(plan_mod, "compile_program", counting)
    return calls


@pytest.fixture
def fast_switching():
    """Switch threads every microsecond, so a race shows up."""
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(saved)


def test_service_single_flight_one_compile_per_key(compiles,
                                                   fast_switching):
    svc = PlanService(device="cpu", async_compile=True, **GEOM)
    rng = np.random.default_rng(2)
    A = rng.choice([-1, 1], size=(5, 9))
    xs = [rng.choice([-1, 1], size=9) for _ in range(8)]
    tickets, barrier = [], threading.Barrier(8)

    def submitter(x):
        barrier.wait(WAIT)
        tickets.append((svc.submit("binary_matvec", A, x), x))

    threads = [threading.Thread(target=submitter, args=(x,)) for x in xs]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        svc.flush()
        assert len(tickets) == 8
        for t, x in tickets:
            assert t.done
            np.testing.assert_array_equal(t.result,
                                          np.where(A @ x >= 0, 1, -1))
        assert svc.stats.misses == 1 and svc.stats.hits == 7
        assert len(compiles) == 1
    finally:
        svc.close()


def test_threaded_async_matches_sync(monkeypatch, compiles):
    """Tickets under threaded async admission equal a synchronous
    service's, bit for bit; the pool compiled some of the misses, and every
    replay table was built on the flushing thread, never on a worker."""
    reqs = _mixed_requests(np.random.default_rng(0), 15)
    sync = PlanService(device="cpu", **GEOM)
    want = [sync.submit(kind, *args) for kind, args in reqs]
    sync.flush()

    warmed = []
    real_prewarm = serve_matpim.prewarm_replay

    def recording(cp, device):
        warmed.append(threading.get_ident())
        return real_prewarm(cp, device)

    monkeypatch.setattr(serve_matpim, "prewarm_replay", recording)
    compiles.clear()
    svc = PlanService(device="cpu", async_compile=True, compile_workers=2,
                      **GEOM)
    tickets = [None] * len(reqs)
    errors = []

    def submitter(lane):
        try:
            for i in range(lane, len(reqs), 4):
                kind, args = reqs[i]
                tickets[i] = svc.submit(kind, *args)
        except Exception as e:  # pragma: no cover - diagnostic
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(lane,))
               for lane in range(4)]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT)
        assert not errors and all(t is not None for t in tickets)
        svc.flush()
        for t, w in zip(tickets, want):
            assert t.done and (t.kind, t.cycles, t.n_units) == \
                (w.kind, w.cycles, w.n_units)
            np.testing.assert_array_equal(np.asarray(t.result),
                                          np.asarray(w.result))
        s = svc.stats
        assert s.hits + s.misses == s.requests == len(reqs)
        assert s.misses == sync.stats.misses == len(compiles)
        assert 0 < s.async_compiles <= s.misses and s.store_hits == 0
        assert s.prewarms == s.async_compiles == len(warmed)
        assert set(warmed) == {threading.get_ident()}
    finally:
        svc.close()


def test_queue_overflow_compiles_inline():
    reqs = _mixed_requests(np.random.default_rng(4), 12)
    svc = PlanService(device="cpu", async_compile=True, compile_workers=1,
                      compile_queue=1, **GEOM)
    try:
        tickets = [svc.submit(kind, *args) for kind, args in reqs]
        assert svc.ready_units <= svc.pending_units
        svc.flush()
        assert all(t.done for t in tickets)
        s = svc.stats
        assert s.hits + s.misses == s.requests == len(reqs)
        assert 0 <= s.async_compiles <= s.misses
        assert svc.ready_units == svc.pending_units == 0
        assert len(svc.cached_keys()) == s.misses
    finally:
        svc.close()


def test_run_stream_async_matches_sync():
    reqs = _mixed_requests(np.random.default_rng(6), 12)
    sync = PlanService(device="cpu", **GEOM)
    want = sync.run_stream([serve_matpim.ServeRequest(k, a)
                            for k, a in reqs], slots=8)
    svc = PlanService(device="cpu", async_compile=True, **GEOM)
    try:
        got = svc.run_stream([serve_matpim.ServeRequest(k, a)
                              for k, a in reqs], slots=8)
        assert len(got) == len(want) == len(reqs)
        for t, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(t.result),
                                          np.asarray(w.result))
            assert t.cycles == w.cycles
    finally:
        svc.close()


def test_failed_async_compile_surfaces(monkeypatch):
    import repro_torch.core.plan as plan_mod
    real = plan_mod.compile_program
    calls = {"n": 0}

    def explode_second(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("lowering exploded")
        return real(*args, **kwargs)

    monkeypatch.setattr(plan_mod, "compile_program", explode_second)
    svc = PlanService(device="cpu", async_compile=True, **GEOM)
    try:
        svc.submit("binary_matvec", np.ones((3, 9), int), np.ones(9, int))
        svc.submit("matvec", np.ones((3, 9), int), np.ones(9, int), 4)
        with pytest.raises(RuntimeError, match="lowering exploded"):
            svc.flush()
        # the failed job is gone: the parked bucket runs, compiling inline
        svc.flush()
        assert not svc._queue
    finally:
        svc.close()
