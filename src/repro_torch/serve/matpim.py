"""Plan-cache serving layer on a torch device: the port of
``src/repro/serve/matpim.py``.

:class:`PlanService` caches compiled+fused plans in a bounded LRU keyed by
``(algorithm, bucket shape, geometry, fuse, backend)`` with hit / miss /
eviction stats; evicted plans drop their executor memoizations
(``CompiledProgram.clear_caches()``), releasing their device tables. A
stream of heterogeneous requests — ±1 matvec, full-precision matvec and
full-precision conv — is **bucketed** by plan key: request shapes round up
to power-of-two buckets, operands are padded with each algorithm's identity
(+1 for binary, zeros for full precision), and every bucket coalesces onto
the batch axis of one ``execute_batch`` call on the service's device — one
kernel launch for all the bucket's tiles on the ``kernels`` backend. Results
scatter back per request (popcounts re-thresholded at the true operand
length, conv maps cropped to the true valid region). Conv programs that do
not depend on the kernel serve every kernel of their shape from one plan,
so requests with distinct kernels share a batch.

Two driving modes: the synchronous ``submit_* / flush`` API runs
everything pending, and :meth:`PlanService.run_stream` is a host-side
continuous-batching loop — admit requests until the in-flight unit budget
is full, execute the fullest bucket (with anti-starvation aging), repeat —
with per-request cycles and wall-time metrics on every :class:`Ticket`.

Not ported yet (each raises; ROADMAP Queue 1 lists them): the async compile
pool (``async_compile=True``), the persistent plan store (any ``store``
other than ``None``/``False``; the port has no ``$MATPIM_PLAN_STORE``
default), multi-device dispatch (``devices > 1``), the binary conv
submission (``submit_binary_conv``), and ``FaultModel`` requests.
``FaultRealization`` requests coalesce by concatenating their masks along
the batch axis.

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
from ..core.tiling import (TiledBinaryMatvec, TiledConv2d, TiledMatvec,
                           majority_sign)
from ..device.faults import FaultModel, FaultRealization
from ..obs import metrics as _metrics
from ..obs.trace import span as _span


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
    once), and ``compile_s + warmup_s`` is the total cold-plan cost.
    """

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    requests: int = 0
    batches: int = 0       # execute_batch calls issued
    units: int = 0         # crossbar images executed (batch sizes summed)
    compile_s: float = 0.0  # wall time spent building/compiling plans (misses)
    # wall of each plan's FIRST engine batch: replay-plan construction and
    # the first kernel build/load, kept out of steady-state execute
    warmup_s: float = 0.0

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
    """

    def __init__(self, max_plans: int = 32, backend: str = "torch",
                 fuse: bool = True, rows: int = 1024, cols: int = 1024,
                 parts: int = 32, bucket: bool = True, bucket_floor: int = 8,
                 max_batch: Optional[int] = None, max_starve_steps: int = 4,
                 device="cuda", async_compile: bool = False, store=None,
                 devices: Optional[int] = None):
        if async_compile:
            raise NotImplementedError(
                "async_compile=True needs the compile pool, not ported to "
                "repro_torch yet (ROADMAP Queue 1, item 5)")
        if store not in (None, False):
            raise NotImplementedError(
                "the persistent plan store is not ported to repro_torch yet "
                "(ROADMAP Queue 1, item 5); pass store=None or False")
        if devices is not None and int(devices) > 1:
            raise NotImplementedError(
                "multi-device dispatch is not ported to repro_torch yet "
                "(ROADMAP Queue 1, item 14)")
        self.device = resolve_device(device)
        if not fuse and backend == "torch":
            backend = "torch-unfused"    # honor the unfused policy explicitly
        parse_backend(backend)           # reject unknown backends up front
        self.backend = backend
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
        self._lock = threading.RLock()

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
            with _span("serve.plan_build", key=repr(key)):
                w = factory()
                w.plan.compile(fuse=self.fuse)
            dt = time.perf_counter() - t0
            self.stats.compile_s += dt
            _metrics.counter("serve.compile_s").inc(dt)
            self._plans[key] = w           # may evict -> _on_plan_evict
            return w

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
                "FaultModel sampling is not ported to repro_torch yet "
                "(ROADMAP Queue 1, item 10); pass a FaultRealization")

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

    def _submit_conv(self, img: np.ndarray, K: np.ndarray, N: int,
                     faults) -> Ticket:
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
        # the kernel joins the cache key only when the lowered program
        # depends on it (the full-precision plan specializes only in the
        # stream-kernel fallback). Kernel-independent plans serve EVERY
        # kernel of the shape: requests with distinct kernels share one
        # compiled plan and coalesce into one batch (each tile loads its
        # own kernel as data). The probe constructor is cheap — programs
        # build lazily below.
        probe = TiledConv2d(Hb, Wb, k, N, rows=rows, cols=cols, parts=parts)
        kernel_dep = probe.plan.specialize or probe.plan.stream_kernel
        key = ("conv", (Hb, Wb), k, int(N),
               K.tobytes() if kernel_dep else None, self.geometry,
               self.fuse, self.backend)

        def factory():
            probe.plan.ensure_program(K)   # program build lands in compile_s
            return probe

        w = self._get_plan(key, factory)
        # zero-pad bottom/right; the true valid region [0:H-k+1, 0:W-k+1]
        # only reads real pixels, so cropping it back is exact
        imgp = np.zeros((Hb, Wb), dtype=np.int64)
        imgp[:H, :Wd] = img
        load, decode, fin = w.bind(imgp, K)
        oh, ow = H - k + 1, Wd - k + 1

        def finalize(tiles):
            out, depth = fin(tiles)
            return out[:oh, :ow], depth

        return self._enqueue(self._ticket("conv", key, w.n_tiles),
                             w, load, decode, finalize, faults)

    def submit_conv(self, img: np.ndarray, K: np.ndarray, N: int,
                    faults=None) -> Ticket:
        """Full-precision valid 2D correlation mod 2^N (negative taps ride
        two's-complement encoding). Result is the (H-k+1, W-k+1) raw
        map."""
        return self._submit_conv(img, K, N, faults)

    def submit_binary_conv(self, img: np.ndarray, K: np.ndarray,
                           faults=None) -> Ticket:
        """The reference's ±1-kernel binary conv (§III-C); raises until
        ``BinaryConvPlan`` is ported (ROADMAP Queue 1, item 8)."""
        raise NotImplementedError(
            "submit_binary_conv needs BinaryConvPlan, not ported to "
            "repro_torch yet (ROADMAP Queue 1, item 8)")

    # -- execution -----------------------------------------------------------

    @property
    def pending_units(self) -> int:
        return sum(p.ticket.n_units for p in self._queue)

    @staticmethod
    def _exec_key(p: _Pending) -> tuple:
        # requests coalesce when they share the plan AND the fault kind:
        # explicit realizations batch with each other (masks concatenate),
        # ideal runs with ideal
        f = "realization" if p.faults is not None else "ideal"
        return (p.ticket.key, f)

    def _buckets(self) -> "OrderedDict[tuple, List[_Pending]]":
        """Pending requests grouped by exec key, in submission order."""
        out: "OrderedDict[tuple, List[_Pending]]" = OrderedDict()
        for p in self._queue:
            out.setdefault(self._exec_key(p), []).append(p)
        return out

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
            res = plan.execute_batch(mems, backend=self.backend,
                                     device=self.device,
                                     max_batch=self.max_batch, faults=faults)
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

    def flush(self) -> List[Ticket]:
        """Run every pending request, one engine batch per bucket."""
        done = []
        with self._lock, _span("serve.flush",
                               pending_units=self.pending_units):
            while self._queue:
                self._step += 1
                done.extend(self._run_bucket(
                    next(iter(self._buckets().values()))))
        _metrics.gauge("serve.queue_depth_units").set(0)
        return done

    def step(self, max_units: Optional[int] = None) -> List[Ticket]:
        """One serve-loop step: execute the fullest bucket (up to
        ``max_units`` crossbar images), leave the rest queued.

        Anti-starvation aging: a bucket whose oldest request has waited
        ``max_starve_steps`` steps is served first (oldest such bucket
        wins), bounding every request's queue delay.
        """
        with self._lock:
            if not self._queue:
                return []
            _metrics.gauge("serve.queue_depth_units").set(self.pending_units)
            buckets = list(self._buckets().values())
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
        it queued.
        """
        if slots < 1:
            raise ValueError(f"slots={slots}: need at least one in-flight "
                             f"crossbar unit to admit work")
        it = iter(requests)
        exhausted = False
        tickets: List[Ticket] = []
        with _span("serve.stream", slots=slots) as sp:
            while True:
                with _span("serve.admit", slots=slots):
                    while not exhausted and self.pending_units < slots:
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
