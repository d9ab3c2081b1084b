"""Plan-cache serving layer on a torch device: the port of
``src/repro/serve/matpim.py``.

:class:`PlanService` caches compiled+fused plans in a bounded LRU keyed by
``(algorithm, bucket shape, geometry, fuse, backend)`` with hit / miss /
eviction stats; evicted plans drop their executor memoizations
(``CompiledProgram.clear_caches()``), releasing their device tables. A
stream of heterogeneous requests — ±1 matvec, full-precision matvec,
full-precision conv and ±1 binary conv — is **bucketed** by plan key:
request shapes round up
to power-of-two buckets, operands are padded with each algorithm's identity
(+1 for binary, zeros for full precision), and every bucket coalesces onto
the batch axis of one ``execute_batch`` call on the service's device — one
kernel launch for all the bucket's tiles on the ``kernels`` backend. Results
scatter back per request (popcounts re-thresholded at the true operand
length, conv maps cropped to the true valid region). Conv programs that do
not depend on the kernel serve every kernel of their shape from one plan,
so requests with distinct kernels share a batch; binary conv programs bake
the kernel into their gates, so its bytes join the plan key.

Two driving modes: the synchronous ``submit_* / flush`` API runs
everything pending, and :meth:`PlanService.run_stream` is a host-side
continuous-batching loop — admit requests until the in-flight unit budget
is full, execute the fullest bucket (with anti-starvation aging), repeat —
with per-request cycles and wall-time metrics on every :class:`Ticket`.

Cold plans cost host compilation. ``store=`` persists compiled traces
(:mod:`.plan_store`), so a restarted service loads them instead of
compiling; ``async_compile=True`` moves misses onto a pool of host worker
threads (:mod:`.compile_pool`) while warm buckets keep running; with either
on, the thread that lands a plan builds its device replay tables before the
first batch (``prewarm``). ``backend="auto"`` picks a backend per
(program, batch bucket) from the autotuner's table, timing the candidates
inline on a cold pair (:mod:`repro_torch.core.autotune`).

Not ported yet (each raises): multi-device dispatch (``devices > 1``,
``distributed/mesh_exec.py``) and ``FaultModel`` requests (sampling in
``device/faults.py``). ``FaultRealization`` requests coalesce by
concatenating their masks along the batch axis.

>>> import numpy as np
>>> svc = PlanService(rows=64, cols=256, parts=8, device="cpu")
>>> A = np.ones((3, 10), dtype=int); x = np.ones(10, dtype=int)
>>> t1 = svc.submit_binary_matvec(A, x)
>>> t2 = svc.submit_binary_matvec(-A[:2, :9], np.ones(9, dtype=int))
>>> _ = svc.flush()
>>> [int(v) for v in t1.result], [int(v) for v in t2.result]
([1, 1, 1], [-1, -1])
>>> svc.stats.misses, t1.key == t2.key   # mixed shapes, one bucket plan
(1, True)
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.compile import RunnerCache
from ..core.engine import parse_backend, resolve_device
from ..core.fused import prewarm_replay
from ..core.kernel_exec import kernels_eligible
from ..core.tiling import (TiledBinaryMatvec, TiledConv2d, TiledMatvec,
                           majority_sign)
from ..device.faults import FaultModel, FaultRealization
from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .compile_pool import CompilePool
from .plan_store import PlanStore, get_default_store


def bucket_up(v: int, floor: int = 8) -> int:
    """Round ``v`` up to the service's power-of-two shape buckets.

    >>> bucket_up(3), bucket_up(8), bucket_up(9), bucket_up(100)
    (8, 8, 16, 128)
    >>> bucket_up(0)
    Traceback (most recent call last):
        ...
    ValueError: bucket_up: size must be positive, got 0
    """
    v, floor = int(v), int(floor)
    if v < 1:
        raise ValueError(f"bucket_up: size must be positive, got {v}")
    if floor < 1:
        raise ValueError(f"bucket_up: floor must be positive, got {floor}")
    return max(floor, 1 << (v - 1).bit_length())


@dataclasses.dataclass
class CacheStats:
    """Plan-cache and batching counters for one :class:`PlanService`.

    ``hits + misses == requests`` (every submit resolves a plan exactly
    once), and ``compile_s + warmup_s`` is the total cold-plan cost (an
    async compile's wall accrues when its job lands). ``async_compiles``
    counts misses compiled on the worker pool; ``store_hits`` counts misses
    served by deserializing the plan store instead of ``compile_program``
    (``store_hits <= misses``).
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    requests: int = 0
    batches: int = 0       # execute_batch calls issued
    units: int = 0         # crossbar images executed (batch sizes summed)
    compile_s: float = 0.0  # wall time spent building/compiling plans (misses)
    # wall of each plan's FIRST engine batch: replay-plan construction and
    # the first kernel build/load, kept out of steady-state execute; a
    # prewarmed plan books its replay-table build here instead
    warmup_s: float = 0.0
    async_compiles: int = 0   # misses compiled off-path by the worker pool
    store_hits: int = 0       # misses served from the persistent plan store
    prewarms: int = 0         # plans whose replay tables were built early

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = dataclasses.asdict(self)
        d["hit_rate"] = self.hit_rate
        return d


@dataclasses.dataclass
class Ticket:
    """Handle for one submitted request; filled in when its bucket runs."""

    uid: int
    kind: str
    key: tuple                      # plan-cache key the request bucketed to
    n_units: int                    # crossbar images this request contributes
    result: object = None
    cycles: Optional[int] = None    # in-array program cycles (tiles lockstep)
    reduce_depth: int = 0           # host tree-reduction levels on top
    # true per-request end-to-end latency: submit -> decode+finalize done
    # (includes queueing); the shared engine-batch wall is batch_wall_s
    wall_s: Optional[float] = None
    batch_wall_s: Optional[float] = None  # wall of the engine batch serving it
    batch_units: Optional[int] = None  # crossbars coalesced in that batch
    backend: Optional[str] = None   # engine label of that batch
    queue_steps: int = 0            # serve-loop steps spent waiting
    submitted_s: Optional[float] = None  # perf_counter stamp at submit
    done: bool = False


@dataclasses.dataclass
class ServeRequest:
    """One element of a request stream for :meth:`PlanService.run_stream`:
    ``kind`` picks the ``submit_<kind>`` method, ``args``/``kwargs`` are its
    operands (e.g. ``ServeRequest("binary_matvec", (A, x))``)."""

    kind: str
    args: tuple
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Pending:
    ticket: Ticket
    wrapper: object                 # tiled wrapper (kept alive past eviction)
    load: Callable                  # load_tile(b, mem) from bind()
    decode: Callable                # decode_tile(b, mem) from bind()
    finalize: Callable              # partials -> request result
    faults: object = None
    submitted_step: int = 0


def _concat_realizations(reals: List[FaultRealization]) -> FaultRealization:
    """Stack per-request realizations along the batch axis (same trace)."""
    if len(reals) == 1:
        return reals[0]
    return FaultRealization(
        sa0=np.concatenate([r.sa0 for r in reals]),
        sa1=np.concatenate([r.sa1 for r in reals]),
        switch=np.concatenate([r.switch for r in reals]),
        init_flip=np.concatenate([r.init_flip for r in reals]))


class PlanService:
    """LRU-bounded plan cache + request batcher on one torch device.

    One service owns one crossbar geometry ``(rows, cols, parts)``, one
    engine ``backend``, one ``fuse`` policy and one ``device`` (``"cuda"``
    by default; without CUDA the constructor raises unless ``device="cpu"``).
    ``max_plans`` bounds the cache: the least-recently-used plan is dropped
    (and its executor caches cleared) past the bound. ``bucket=False``
    disables shape bucketing. A coarse re-entrant lock makes submit, flush
    and step safe to call from several threads; execution is serial.

    ``backend="auto"`` consults the autotuner's table per (program, batch
    bucket): ``tunings`` pins a :class:`~repro_torch.core.autotune.
    TuningTable` (``None`` uses the process default,
    ``$MATPIM_TORCH_TUNINGS``), and ``autotune`` (default: on with
    ``"auto"``) times the candidates inline on a cold pair's first batch;
    that batch's result is labelled ``auto:<winner>`` like the later ones.
    ``store`` is ``None`` (the ``$MATPIM_TORCH_PLAN_STORE`` default, else
    none), ``False`` (none), a :class:`~repro_torch.serve.plan_store.
    PlanStore` or a path. ``async_compile=True`` compiles misses on
    ``compile_workers`` host threads behind a queue of ``compile_queue``
    jobs. ``prewarm`` (default: on with a store or async compile) builds a
    landed plan's device replay tables on the landing thread before its
    first batch.
    """

    def __init__(self, max_plans: int = 32, backend: str = "torch",
                 fuse: bool = True, rows: int = 1024, cols: int = 1024,
                 parts: int = 32, bucket: bool = True, bucket_floor: int = 8,
                 max_batch: Optional[int] = None, max_starve_steps: int = 4,
                 device="cuda", tunings=None, autotune: Optional[bool] = None,
                 async_compile: bool = False, compile_workers: int = 2,
                 compile_queue: int = 8, store=None,
                 devices: Optional[int] = None,
                 prewarm: Optional[bool] = None):
        if devices is not None and int(devices) > 1:
            raise NotImplementedError(
                "multi-device dispatch (distributed/mesh_exec.py) is not "
                "ported to repro_torch yet")
        self.device = resolve_device(device)
        if not fuse and backend in ("torch", "auto"):
            # honor the unfused policy explicitly; auto would re-fuse
            backend = "torch-unfused"
        parse_backend(backend)           # reject unknown backends up front
        self.backend = backend
        self.tunings = tunings
        self._auto = self.backend == "auto"
        self.autotune = self._auto if autotune is None else bool(autotune)
        self.fuse = bool(fuse)
        self.max_plans = int(max_plans)
        self.geometry = (int(rows), int(cols), int(parts))
        self.bucket = bool(bucket)
        self.bucket_floor = int(bucket_floor)
        self.max_batch = max_batch
        self.max_starve_steps = int(max_starve_steps)
        self.stats = CacheStats()
        # the same bounded LRU the executors use for their memoization; the
        # eviction hook releases the evicted plan's device tables (an
        # in-flight request still holds its wrapper and rebuilds lazily)
        self._plans = RunnerCache(max_entries=self.max_plans,
                                  on_evict=self._on_plan_evict)
        self._queue: List[_Pending] = []
        self._uid = 0
        self._step = 0
        if store is None:
            self.store: Optional[PlanStore] = get_default_store()
        elif store is False:
            self.store = None
        elif isinstance(store, PlanStore):
            self.store = store
        else:
            self.store = PlanStore(store)
        # async admit path: misses enqueue compile jobs on a bounded worker
        # pool while warm buckets keep running; the pool is lazy (first
        # async miss) so sync services never spawn threads
        self.async_compile = bool(async_compile)
        self._compile_workers = int(compile_workers)
        self._compile_queue = int(compile_queue)
        self._pool: Optional[CompilePool] = None
        # plan key -> (CompileJob, wrapper) for in-flight async compiles;
        # buckets whose key is here are parked until the job lands
        self._compiling: Dict[tuple, tuple] = {}
        self.prewarm = ((self.store is not None or self.async_compile)
                        if prewarm is None else bool(prewarm))
        # workers never take this lock (job closures touch only the wrapper
        # and the store), so holding it while waiting on a job cannot
        # deadlock
        self._lock = threading.RLock()

    def close(self) -> None:
        """Shut down the compile pool; in-flight jobs finish first."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    # -- plan cache ----------------------------------------------------------

    def _on_plan_evict(self, wrapper) -> None:
        wrapper.plan.clear_caches()
        self.stats.evictions += 1
        _metrics.counter("serve.cache.evictions").inc()

    def _get_plan(self, key: tuple, factory: Callable):
        with self._lock:
            w = self._plans.get(key)       # LRU touch on hit
            if w is not None:
                self.stats.hits += 1
                _metrics.counter("serve.cache.hits").inc()
                return w
            self.stats.misses += 1
            _metrics.counter("serve.cache.misses").inc()
            t0 = time.perf_counter()
            stored = False
            with _span("serve.plan_build", key=repr(key)):
                w = factory()
                # compile here (store load, else lowering) unless the async
                # path took the job: then its cost accrues when it lands
                if not self._compile_async(key, w):
                    stored = self._compile_sync(key, w)
            dt = time.perf_counter() - t0
            self.stats.compile_s += dt
            _metrics.counter("serve.compile_s").inc(dt)
            if stored:
                self._prewarm(w)
            self._plans[key] = w           # may evict -> _on_plan_evict
            return w

    def cached_keys(self) -> List[tuple]:
        """Current cache keys, least-recently-used first."""
        return list(self._plans.keys())

    # -- persistent store + async compilation --------------------------------

    def _load_from_store(self, key: tuple, plan) -> bool:
        """Adopt a deserialized trace for ``key`` if the store has one."""
        if self.store is None:
            return False
        cp = self.store.load(key)
        if cp is None:
            return False
        try:
            plan.adopt_compiled(cp)
        except ValueError:
            return False        # geometry drift -> recompile
        return True

    def _compile_sync(self, key: tuple, w) -> bool:
        """Miss path on the caller's thread: store load, else lower + put.
        Returns whether the trace came from the store."""
        if self._load_from_store(key, w.plan):
            self.stats.store_hits += 1
            return True
        cp = w.plan.compile(fuse=self.fuse)
        if self.store is not None and not self.store.entry_path(key).exists():
            self.store.put(key, cp)
        return False

    def _prewarm(self, w) -> None:
        """Build a compiled plan's device replay tables now (on this
        thread, the one that landed the plan) so its first batch runs at
        steady state; the wall books as warm-up. A plan that the kernels
        compute builds none on ``kernels`` or ``auto`` (whose heuristic
        picks the kernels for it); should a table pick replay, its first
        batch builds them."""
        if not self.prewarm:
            return
        t0 = time.perf_counter()
        with _span("serve.prewarm"):
            cp = w.plan.compile(fuse=self.fuse)
            if self.backend not in ("kernels", "auto") \
                    or not kernels_eligible(cp):
                prewarm_replay(cp, self.device)
        dt = time.perf_counter() - t0
        w._served_once = True
        self.stats.warmup_s += dt
        self.stats.prewarms += 1
        _metrics.counter("serve.warmup_s").inc(dt)
        _metrics.counter("serve.prewarms").inc()

    def _compile_async(self, key: tuple, w) -> bool:
        """Try to move the miss's compile onto the worker pool.

        Falls back to sync (returns False) when async is off, when there is
        nothing pending to overlap with (single-request latency must not
        regress), or when the bounded queue is full (backpressure degrades
        to inline compiles). The job is host work only: store load or
        lowering, and the store put.
        """
        if not self.async_compile \
                or not (self._queue or self._compiling):
            return False
        if self._pool is None:
            self._pool = CompilePool(workers=self._compile_workers,
                                     max_queue=self._compile_queue)
        store, fuse, plan = self.store, self.fuse, w.plan

        def job():
            if store is not None:
                cp = store.load(key)
                if cp is not None:
                    try:
                        plan.adopt_compiled(cp)
                        return {"store_hit": True}
                    except ValueError:
                        pass        # geometry drift -> recompile
            cp = plan.compile(fuse=fuse)
            if store is not None and not store.entry_path(key).exists():
                store.put(key, cp)
            return {"store_hit": False}

        job_h = self._pool.submit(key, job, block=False)
        if job_h is None:
            return False            # queue full -> compile inline
        self._compiling[key] = (job_h, w)
        self.stats.async_compiles += 1
        _metrics.counter("serve.async_compiles").inc()
        return True

    def _collect_landed(self, wait: bool = False,
                        timeout: Optional[float] = None) -> int:
        """Integrate finished compile jobs; their buckets become ready.

        ``wait=True`` blocks until at least one in-flight job signals,
        bounding the loop's idle spin when every pending bucket is parked
        behind a compile. A job's error is raised here.
        """
        with self._lock:
            jobs = sorted(self._compiling.items(),
                          key=lambda kv: kv[1][0].submitted_s)
        if not jobs:
            return 0
        if wait and not any(j.done.is_set() for _, (j, _) in jobs):
            jobs[0][1][0].wait(timeout)
        landed = 0
        for key, (job, w) in jobs:
            if not job.done.is_set():
                continue
            with self._lock:
                if self._compiling.pop(key, None) is None:
                    continue        # another thread integrated it
                if job.error is not None:
                    raise job.error
                self.stats.compile_s += job.wall_s
                _metrics.counter("serve.compile_s").inc(job.wall_s)
                if (job.result or {}).get("store_hit"):
                    self.stats.store_hits += 1
                self._prewarm(w)
            _metrics.histogram("serve.compile_wait_us").observe(
                (job.finished_s - job.submitted_s) * 1e6)
            landed += 1
        return landed

    # -- request submission --------------------------------------------------

    def _bucket2(self, m: int, k: int) -> Tuple[int, int]:
        if not self.bucket:
            return int(m), int(k)
        return (bucket_up(m, self.bucket_floor),
                bucket_up(k, self.bucket_floor))

    def _ticket(self, kind: str, key: tuple, n_units: int) -> Ticket:
        with self._lock:
            self._uid += 1
            self.stats.requests += 1
            uid = self._uid
        _metrics.counter("serve.requests").inc()
        return Ticket(uid=uid, kind=kind, key=key, n_units=n_units,
                      submitted_s=time.perf_counter())

    def _enqueue(self, ticket, wrapper, load, decode, finalize, faults):
        if isinstance(faults, FaultRealization) \
                and faults.batch != ticket.n_units:
            raise ValueError(
                f"FaultRealization batch {faults.batch} != the request's "
                f"{ticket.n_units} crossbar units; sample it per request "
                f"(n_cycles/W/I of wrapper.plan.compile())")
        with self._lock:
            self._queue.append(_Pending(
                ticket=ticket, wrapper=wrapper, load=load, decode=decode,
                finalize=finalize, faults=faults,
                submitted_step=self._step))
        return ticket

    def submit(self, kind: str, *args, **kw) -> Ticket:
        """Dispatch to ``submit_<kind>`` (the :class:`ServeRequest` path)."""
        return getattr(self, f"submit_{kind}")(*args, **kw)

    @staticmethod
    def _reject_fault_model(faults) -> None:
        if isinstance(faults, FaultModel):
            raise NotImplementedError(
                "FaultModel sampling (device/faults.py) is not ported to "
                "repro_torch yet; pass a FaultRealization")

    @classmethod
    def _operands(cls, A, x, faults) -> Tuple[np.ndarray, np.ndarray]:
        """Matvec operands as arrays, shapes checked; FaultModel requests
        raise."""
        cls._reject_fault_model(faults)
        A = np.asarray(A)
        x = np.asarray(x)
        if A.ndim != 2 or x.shape != (A.shape[1],):
            raise ValueError(f"A shape {A.shape} and x shape {x.shape} do "
                             f"not form a matvec")
        return A, x

    def submit_binary_matvec(self, A: np.ndarray, x: np.ndarray,
                             faults=None) -> Ticket:
        """±1 matvec ``y = sign(A @ x)``; result is the (m,) sign vector."""
        A, x = self._operands(A, x, faults)
        m, k = A.shape
        Mb, Kb = self._bucket2(m, k)
        rows, cols, parts = self.geometry
        key = ("binary_matvec", (Mb, Kb), self.geometry, self.fuse,
               self.backend)
        w = self._get_plan(key, lambda: TiledBinaryMatvec(
            Mb, Kb, rows=rows, cols=cols, parts=parts))
        # bucket padding with the binary identity: +1 rows/cols each add one
        # XNOR match per row, subtracted before the host-side sign below
        Ap = np.ones((Mb, Kb), dtype=np.int64)
        Ap[:m, :k] = A
        xp = np.ones(Kb, dtype=np.int64)
        xp[:k] = x
        load, decode, fin = w.bind(Ap, xp)
        pad_k = Kb - k

        def finalize(partials):
            pop, depth = fin(partials)      # bucket-length popcounts
            return majority_sign(pop[:m] - pad_k, k), depth

        return self._enqueue(self._ticket("binary_matvec", key, w.n_tiles),
                             w, load, decode, finalize, faults)

    def submit_matvec(self, A: np.ndarray, x: np.ndarray, N: int,
                      faults=None) -> Ticket:
        """Full-precision ``y = A @ x mod 2^(2N)`` (N-bit operands)."""
        A, x = self._operands(A, x, faults)
        m, k = A.shape
        Mb, Kb = self._bucket2(m, k)
        rows, cols, parts = self.geometry
        key = ("matvec", (Mb, Kb), int(N), self.geometry, self.fuse,
               self.backend)
        w = self._get_plan(key, lambda: TiledMatvec(
            Mb, Kb, N, rows=rows, cols=cols, parts=parts))
        Ap = np.zeros((Mb, Kb), dtype=np.int64)   # zero-pad: adds 0 mod 2^2N
        Ap[:m, :k] = A
        xp = np.zeros(Kb, dtype=np.int64)
        xp[:k] = x
        load, decode, fin = w.bind(Ap, xp)

        def finalize(partials):
            y, depth = fin(partials)
            return y[:m], depth

        return self._enqueue(self._ticket("matvec", key, w.n_tiles),
                             w, load, decode, finalize, faults)

    def _submit_conv(self, kind: str, img: np.ndarray, K: np.ndarray,
                     N: int, binary: bool, faults) -> Ticket:
        self._reject_fault_model(faults)
        img = np.asarray(img)
        K = np.asarray(K, dtype=np.int64)
        H, Wd = img.shape
        k = K.shape[0]
        if K.shape != (k, k):
            raise ValueError(f"kernel shape {K.shape} is not square")
        if H < k or Wd < k:
            raise ValueError(f"image {img.shape} smaller than the kernel")
        Hb, Wb = self._bucket2(H, Wd)
        Hb, Wb = max(Hb, k), max(Wb, k)
        rows, cols, parts = self.geometry
        tile_kw = {"tile_n": 64} if binary else {}  # cf. tiled_binary_conv2d
        # the kernel joins the cache key only when the lowered program
        # depends on it (binary taps are baked into gates; the
        # full-precision plan specializes only in the stream-kernel
        # fallback). Kernel-independent plans serve EVERY kernel of the
        # shape: requests with distinct kernels share one compiled plan and
        # coalesce into one batch (each tile loads its own kernel as data).
        # The probe constructor is cheap — programs build lazily below.
        probe = TiledConv2d(Hb, Wb, k, N, binary=binary, rows=rows,
                            cols=cols, parts=parts, **tile_kw)
        kernel_dep = (binary or probe.plan.specialize
                      or probe.plan.stream_kernel)
        key = (kind, (Hb, Wb), k, int(N),
               K.tobytes() if kernel_dep else None, self.geometry,
               self.fuse, self.backend)

        def factory():
            probe.plan.ensure_program(K)   # program build lands in compile_s
            return probe

        w = self._get_plan(key, factory)
        # pad bottom/right with the operand identity (+1 binary, 0 full
        # precision); the true valid region [0:H-k+1, 0:W-k+1] only reads
        # real pixels, so cropping it back is exact
        imgp = np.full((Hb, Wb), 1 if binary else 0, dtype=np.int64)
        imgp[:H, :Wd] = img
        load, decode, fin = w.bind(imgp, K)
        oh, ow = H - k + 1, Wd - k + 1

        def finalize(tiles):
            out, depth = fin(tiles)
            return out[:oh, :ow], depth

        return self._enqueue(self._ticket(kind, key, w.n_tiles),
                             w, load, decode, finalize, faults)

    def submit_conv(self, img: np.ndarray, K: np.ndarray, N: int,
                    faults=None) -> Ticket:
        """Full-precision valid 2D correlation mod 2^N (negative taps ride
        two's-complement encoding). Result is the (H-k+1, W-k+1) raw
        map."""
        return self._submit_conv("conv", img, K, N, binary=False,
                                 faults=faults)

    def submit_binary_conv(self, img: np.ndarray, K: np.ndarray,
                           faults=None) -> Ticket:
        """±1-kernel binary conv (§III-C); result is the ±1 sign map of
        the (H-k+1, W-k+1) valid region."""
        if not set(np.unique(np.asarray(K)).tolist()) <= {-1, 1}:
            raise ValueError("a binary conv kernel holds only -1 and +1")
        return self._submit_conv("binary_conv", img, K, N=1, binary=True,
                                 faults=faults)

    # -- execution -----------------------------------------------------------

    @property
    def pending_units(self) -> int:
        return sum(p.ticket.n_units for p in self._queue)

    @property
    def ready_units(self) -> int:
        """Pending units whose plan is compiled (not parked behind an
        in-flight async compile) — what the admission budget counts."""
        comp = self._compiling
        if not comp:
            return self.pending_units
        return sum(p.ticket.n_units for p in self._queue
                   if p.ticket.key not in comp)

    @staticmethod
    def _exec_key(p: _Pending) -> tuple:
        # requests coalesce when they share the plan AND the fault kind:
        # explicit realizations batch with each other (masks concatenate),
        # ideal runs with ideal
        f = "realization" if p.faults is not None else "ideal"
        return (p.ticket.key, f)

    def _buckets(self, ready_only: bool = True) \
            -> "OrderedDict[tuple, List[_Pending]]":
        """Pending requests grouped by exec key, in submission order;
        ``ready_only`` skips buckets parked behind an in-flight async
        compile."""
        comp = self._compiling
        out: "OrderedDict[tuple, List[_Pending]]" = OrderedDict()
        for p in self._queue:
            if ready_only and comp and p.ticket.key in comp:
                continue
            out.setdefault(self._exec_key(p), []).append(p)
        return out

    def _execute_bucket(self, plan, mems: np.ndarray, faults):
        """One engine call for a coalesced bucket; the autotuner's
        observation point when the service runs ``backend="auto"``.

        A cold ``(program key, batch bucket)`` pair (no tunings entry yet)
        is tuned inline on the real batch: the winning candidate's result
        is the bucket's result, labelled ``auto:<winner>``. Warm pairs run
        the table's choice and fold their wall back into the table.
        """
        if self._auto and faults is None:
            from ..core import autotune as at
            cp = plan.compile(fuse=self.fuse)
            table = (self.tunings if self.tunings is not None
                     else at.get_default_table())
            key = at.program_key(cp)
            bucket = at.batch_bucket(mems.shape[0])
            if self.autotune and table.lookup(key, bucket) is None:
                _metrics.counter("serve.inline_tunes").inc()
                res, e = at.autotune_execute(cp, mems, table, cheap=True,
                                             device=self.device)
                res.backend = (f"auto:{e.backend}@{e.max_batch}"
                               if e.max_batch is not None
                               else f"auto:{e.backend}")
                return res
            t0 = time.perf_counter()
            res = plan.execute_batch(mems, backend=self.backend,
                                     device=self.device,
                                     max_batch=self.max_batch, tunings=table)
            us = (time.perf_counter() - t0) * 1e6
            if res.backend.startswith("auto:"):
                # label grammar: auto:<backend>[@<max_batch>]
                resolved, _, mb = res.backend[len("auto:"):].partition("@")
                table.observe(key, bucket, resolved, us,
                              max_batch=int(mb) if mb else None)
            return res
        return plan.execute_batch(mems, backend=self.backend,
                                  device=self.device,
                                  max_batch=self.max_batch, faults=faults,
                                  tunings=self.tunings)

    def _run_bucket(self, pends: List[_Pending]) -> List[Ticket]:
        """Coalesce one bucket onto the engine batch axis and scatter back
        (caller holds the lock)."""
        w = pends[0].wrapper
        plan = w.plan
        units = sum(p.ticket.n_units for p in pends)
        with _span("serve.bucket", kind=pends[0].ticket.kind, units=units,
                   requests=len(pends)):
            with _span("serve.load", units=units):
                mems = np.zeros((units, plan.rows, plan.cols),
                                dtype=np.uint8)
                off = 0
                for p in pends:
                    for b in range(p.ticket.n_units):
                        p.load(b, mems[off + b])
                    off += p.ticket.n_units
            faults = None
            if pends[0].faults is not None:
                faults = _concat_realizations([p.faults for p in pends])
            warm_up = not getattr(w, "_served_once", False)
            w._served_once = True
            t0 = time.perf_counter()
            res = self._execute_bucket(plan, mems, faults)
            wall = time.perf_counter() - t0
            _metrics.histogram("serve.device.busy_us").observe(wall * 1e6)
            if warm_up:
                # the first engine batch through a plan builds its replay
                # tables (and loads the kernel library): warm-up, not steady
                self.stats.warmup_s += wall
                _metrics.counter("serve.warmup_s").inc(wall)
            done = []
            with _span("serve.decode", units=units):
                off = 0
                for p in pends:
                    partials = [p.decode(b, res.mem[off + b])
                                for b in range(p.ticket.n_units)]
                    off += p.ticket.n_units
                    t = p.ticket
                    t.result, t.reduce_depth = p.finalize(partials)
                    t.cycles = res.cycles
                    t.batch_wall_s = wall
                    t.wall_s = time.perf_counter() - t.submitted_s
                    t.batch_units = units
                    t.backend = res.backend
                    # steps the request sat queued before the serving one
                    t.queue_steps = max(0, self._step - p.submitted_step - 1)
                    t.done = True
                    _metrics.histogram("serve.request_latency_us") \
                        .observe(t.wall_s * 1e6)
                    _metrics.histogram("serve.queue_steps") \
                        .observe(t.queue_steps)
                    done.append(t)
                    self._queue.remove(p)
        self.stats.batches += 1
        self.stats.units += units
        _metrics.counter("serve.batches").inc()
        _metrics.counter("serve.units").inc(units)
        _metrics.histogram("serve.batch_units").observe(units)
        return done

    def _next_buckets(self) -> list:
        """Ready buckets; when every pending bucket is parked behind an
        async compile, wait for one to land. A bucket whose job is gone
        (it failed and raised) runs anyway: execute compiles it."""
        self._collect_landed()
        buckets = list(self._buckets().values())
        if not buckets and self._compiling:
            self._collect_landed(wait=True, timeout=1.0)
            buckets = list(self._buckets().values())
        if not buckets and not self._compiling:
            buckets = list(self._buckets(ready_only=False).values())
        return buckets

    def flush(self) -> List[Ticket]:
        """Run every pending request, one engine batch per bucket; buckets
        parked behind an async compile run once their plan lands."""
        done = []
        with self._lock, _span("serve.flush",
                               pending_units=self.pending_units):
            while self._queue:
                buckets = self._next_buckets()
                if buckets:
                    self._step += 1
                    done.extend(self._run_bucket(buckets[0]))
        _metrics.gauge("serve.queue_depth_units").set(0)
        return done

    def step(self, max_units: Optional[int] = None) -> List[Ticket]:
        """One serve-loop step: execute the fullest bucket (up to
        ``max_units`` crossbar images), leave the rest queued.

        Anti-starvation aging: a bucket whose oldest request has waited
        ``max_starve_steps`` steps is served first (oldest such bucket
        wins), bounding every request's queue delay. Buckets parked behind
        an async compile are not ready; when every pending bucket is, the
        step waits for a plan to land rather than return empty-handed.
        """
        with self._lock:
            if not self._queue:
                return []
            _metrics.gauge("serve.queue_depth_units").set(self.pending_units)
            buckets = self._next_buckets()
            if not buckets:
                return []
            self._step += 1

            def age(ps):
                return self._step - min(p.submitted_step for p in ps)

            def units_of(ps):
                return sum(p.ticket.n_units for p in ps)

            starved = [ps for ps in buckets
                       if age(ps) > self.max_starve_steps]
            pends = (max(starved, key=age) if starved
                     else max(buckets, key=units_of))
            if max_units is not None:
                take, acc = [], 0
                for p in pends:
                    if take and acc + p.ticket.n_units > max_units:
                        break
                    take.append(p)
                    acc += p.ticket.n_units
                pends = take
            with _span("serve.step", step=self._step,
                       pending_units=self.pending_units,
                       starved=bool(starved)):
                done = self._run_bucket(pends)
            _metrics.counter("serve.steps").inc()
            _metrics.gauge("serve.queue_depth_units").set(self.pending_units)
        return done

    def run_stream(self, requests: Iterable[ServeRequest], slots: int = 64,
                   max_units: Optional[int] = None) -> List[Ticket]:
        """Continuous-batching loop over a request stream.

        Admit requests until ``slots`` crossbar units are in flight, execute
        the fullest bucket (:meth:`step`), repeat until the stream and the
        queue drain. Every returned ticket carries its latency in cycles,
        its end-to-end wall latency (``wall_s``: submit → decode done), the
        wall and size of the engine batch that served it, and how many steps
        it queued. With async compiles the budget counts only *ready*
        units, so parked buckets do not block warm traffic; in-flight work
        stays under ``2 * slots`` units.
        """
        if slots < 1:
            raise ValueError(f"slots={slots}: need at least one in-flight "
                             f"crossbar unit to admit work")
        it = iter(requests)
        exhausted = False
        tickets: List[Ticket] = []
        with _span("serve.stream", slots=slots) as sp:
            while True:
                self._collect_landed()
                with _span("serve.admit", slots=slots):
                    while (not exhausted and self.ready_units < slots
                           and self.pending_units < 2 * slots):
                        try:
                            r = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        tickets.append(
                            self.submit(r.kind, *r.args, **r.kwargs))
                if not self._queue:
                    if exhausted:
                        break
                    continue
                self.step(max_units=max_units or slots)
            sp.set(requests=len(tickets))
        return tickets


__all__ = ["CacheStats", "PlanService", "ServeRequest", "Ticket",
           "bucket_up"]
