"""Background compilation worker pool for the serving layer.

The port of ``src/repro/serve/compile_pool.py`` (stdlib threads only).
:class:`repro_torch.serve.matpim.PlanService` lowers+fuses plans
synchronously at miss time, which stalls the whole stream loop for the
duration of a compile (seconds for conv traces) while already-warm buckets
sit executable. This
pool moves that work off the request path: a miss submits a
:class:`CompileJob` (single-flight per plan key), daemon worker threads
drain a **bounded** queue, and the stream loop keeps serving warm buckets —
admitting the new bucket only once its job lands.

Design points, all load-bearing for the test suite:

* **single-flight** — ``submit`` returns the existing in-flight job for a
  key instead of enqueueing a duplicate, so N concurrent submitters of the
  same plan cost exactly one compile (``tests/test_compile_pool.py``).
* **bounded queue** — ``submit(block=False)`` returns ``None`` when the
  queue is full; the service then compiles inline (backpressure degrades
  to the old synchronous behavior, it never queues unboundedly).
* **no shared locks with the service** — job functions close over the plan
  wrapper and the plan store only; workers never touch ``PlanService``
  state, so the service may hold its own lock while waiting on jobs.
* **host work only** — the service's jobs build, load or store host-side
  traces; anything that touches the card (replay tables on the device)
  runs on the thread that lands the job, never on a worker.
* **observability** — a ``serve.compile_pool.queue_depth`` gauge, queue
  wait / run-time histograms, and a ``compile.async`` span around every
  job body (visible in the Perfetto timeline next to ``compile.lower``).

Jobs that raise keep the exception on ``job.error``; the service re-raises
at integration time. Compilation is CPU-bound Python under the GIL, so the
pool's win is *overlap with executor work and store I/O*, not parallel
lowering — ``workers=2`` is plenty.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, List, Optional

from ..obs import metrics as _metrics
from ..obs.trace import span as _span

__all__ = ["CompileJob", "CompilePool"]

_STOP = object()


class CompileJob:
    """One in-flight compile: ``fn`` runs on a worker; ``done`` signals."""

    __slots__ = ("key", "fn", "done", "result", "error",
                 "submitted_s", "started_s", "finished_s")

    def __init__(self, key: object, fn: Callable):
        self.key = key
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.submitted_s = time.perf_counter()
        self.started_s: Optional[float] = None
        self.finished_s: Optional[float] = None

    @property
    def wall_s(self) -> float:
        """Worker time spent running ``fn`` (0.0 until finished)."""
        if self.started_s is None or self.finished_s is None:
            return 0.0
        return self.finished_s - self.started_s

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)


class CompilePool:
    """Bounded work queue + daemon worker threads, single-flight per key."""

    def __init__(self, workers: int = 2, max_queue: int = 8,
                 name: str = "matpim-compile"):
        self.workers = max(1, int(workers))
        self.max_queue = max(1, int(max_queue))
        self._q: "queue.Queue" = queue.Queue(maxsize=self.max_queue)
        self._lock = threading.Lock()
        self._inflight: dict = {}
        self._threads: List[threading.Thread] = []
        self._closed = False
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"{name}-{i}")
            t.start()
            self._threads.append(t)

    # -- introspection -------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Jobs enqueued but not yet picked up by a worker."""
        return self._q.qsize()

    @property
    def inflight(self) -> int:
        """Jobs submitted and not yet finished (queued or running)."""
        with self._lock:
            return len(self._inflight)

    # -- submission ----------------------------------------------------------

    def submit(self, key: object, fn: Callable,
               block: bool = False) -> Optional[CompileJob]:
        """Enqueue ``fn`` under ``key``; single-flight, bounded.

        Returns the (possibly pre-existing) job, or ``None`` when the queue
        is full and ``block=False`` — the caller's cue to compile inline.
        """
        if self._closed:
            raise RuntimeError("CompilePool is shut down")
        with self._lock:
            job = self._inflight.get(key)
            if job is not None:
                return job
            job = CompileJob(key, fn)
            self._inflight[key] = job
        try:
            self._q.put(job, block=block)
        except queue.Full:
            with self._lock:
                self._inflight.pop(key, None)
            _metrics.counter("serve.compile_pool.rejected").inc()
            return None
        _metrics.gauge("serve.compile_pool.queue_depth").set(
            self._q.qsize())
        return job

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait for every currently in-flight job; True if all landed."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            jobs = list(self._inflight.values())
        for j in jobs:
            left = (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))
            if not j.wait(left):
                return False
        return True

    def shutdown(self) -> None:
        """Stop workers after the queued jobs finish (idempotent)."""
        if self._closed:
            return
        self._closed = True
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join()

    # -- worker --------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                self._q.task_done()
                return
            job.started_s = time.perf_counter()
            _metrics.gauge("serve.compile_pool.queue_depth").set(
                self._q.qsize())
            with _span("compile.async", key=repr(job.key)):
                try:
                    job.result = job.fn()
                except BaseException as e:   # surfaces via job.error
                    job.error = e
            job.finished_s = time.perf_counter()
            with self._lock:
                self._inflight.pop(job.key, None)
            _metrics.counter("serve.compile_pool.jobs").inc()
            _metrics.histogram("serve.compile_pool.wait_us").observe(
                (job.started_s - job.submitted_s) * 1e6)
            _metrics.histogram("serve.compile_pool.run_us").observe(
                job.wall_s * 1e6)
            job.done.set()
            self._q.task_done()
