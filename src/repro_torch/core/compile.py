"""Compile stateful-logic programs into packed, vectorizable traces.

Host-side numpy, kept line-for-line with ``src/repro/core/compile.py`` so a
:class:`CompiledProgram` built here is byte-identical to the reference's
(the golden digests in ``tests/golden/`` hold both). The only rename is the
plan-attached layout manifest: ``kernel_spec`` here, ``pallas_spec`` there.

The cycle-accurate interpreter in ``crossbar.py`` executes one micro-op at a
time in Python — faithful, but orders of magnitude slower than the physics it
models (every cycle of a MatPIM program is a fully parallel array event). This
pass lowers a ``Program`` (list of cycles, each a list of co-scheduled
``ColOp``/``RowOp``/``InitOp``) into dense integer arrays that the vectorized
executors in ``engine.py`` replay with a handful of array ops per cycle, and
batch across B independent crossbars at once.

Lowering
--------
Each gate op becomes ``(gate_id, dst, ins[5], mask_id)``: up to ``MAX_FANIN``
gather slots (padded with the constant-0 cell), the output line, and a write
mask selecting the participating rows (column mode) or columns (row mode).
The executors hold memory *bit-plane packed*: cell (r, c) of crossbar b is
bit b of one machine word, so a FELIX gate evaluates as a short boolean
word expression (see ``engine.BIT_GATES``) on the gathered input lines —
B crossbars per word for the price of one. ``InitOp`` cycles lower to
(row-mask, col-mask, value) rectangles. Row-mode cycles are the transpose
picture of column-mode cycles.

Executor memory carries one extra row and column: the extra column (index
``cols``) is the constant-0 gather slot and the no-op write target for
column-mode padding ops (their write masks are all-False, so it stays 0);
symmetrically the extra row (index ``rows``) serves row mode.

Scheduling/partition validation — the physical co-schedulability the latency
claims rest on — runs ONCE here, instead of on every interpreted ``run()``.
The compiled trace also carries the exact cycle count and op-category stats,
bit-identical to what the interpreter would have accumulated.

Macro-op fusion
---------------
:func:`fuse_program` further groups the cycle trace into **macro-op
segments**: runs of same-mode cycles whose gather indices, gate ids and write
masks are precomputed into dense padded arrays — a static schedule in the
spirit of HIPE-MAGIC's ahead-of-time gate grouping. Segments let the
executors in ``engine.py``/``fused.py`` replay the trace without per-cycle
dispatch: the ``torch-fused`` backend replays each segment's *independent
spans* (consecutive cycles with no data dependence) as single batched
gather/eval/scatter calls on the device.
Fusion is a simulator-speed optimization only: ``FusedSchedule.n_cycles``
always equals the unfused trace length, and final memory is bit-identical
(the cross-backend conformance suite enforces both).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..obs import metrics as _metrics
from ..obs.trace import span as _span
from .crossbar import SchedulingError, col_group, groups_disjoint, row_group
from .isa import GATES, ColOp, InitOp, RowOp

MODE_COL, MODE_ROW, MODE_INIT = 0, 1, 2
MAX_FANIN = 5

# stable gate numbering shared with engine.BIT_GATES
GATE_IDS: Dict[str, int] = {
    "NOT": 0, "OR2": 1, "NOR2": 2, "NOR3": 3,
    "NAND2": 4, "MIN3": 5, "MIN5": 6, "OAI3": 7,
}


class _MaskPool:
    """Deduplicated pool of boolean selection masks (length ``size + 1``).

    The trailing entry is the padding row/column and is never selected, so
    masked writes can never touch the constant-0 / no-op cells. Id 0 is the
    all-False mask used by padding ops.
    """

    def __init__(self, size: int):
        self.size = size
        self._ids: Dict[bytes, int] = {}
        self.masks: List[np.ndarray] = []
        self.id_for(np.zeros(size + 1, dtype=bool))

    def id_for(self, mask: np.ndarray) -> int:
        key = mask.tobytes()
        mid = self._ids.get(key)
        if mid is None:
            mid = len(self.masks)
            self._ids[key] = mid
            self.masks.append(mask)
        return mid

    def sel_id(self, sel: object) -> int:
        """Mask id for a row/col selection (None, slice, int, or index list)."""
        mask = np.zeros(self.size + 1, dtype=bool)
        if sel is None:
            mask[: self.size] = True
        elif isinstance(sel, slice):
            mask[: self.size][sel] = True
        else:
            idx = np.atleast_1d(np.asarray(sel, dtype=np.intp))
            if idx.size and (idx.min() < 0 or idx.max() >= self.size):
                raise SchedulingError(f"selection out of range: {sel}")
            mask[idx] = True
        return self.id_for(mask)

    def stack(self) -> np.ndarray:
        return np.stack(self.masks, axis=0)


# ceiling on memoized executor artifacts per CompiledProgram (replay plans,
# keyed by kind and device). A steady-state caller's working set is 1-2
# entries; the bound exists so a long-lived service touching many devices
# cannot retain one device-resident replay table per key forever.
CACHE_MAX_ENTRIES = 8

# aggregate live-entry counts per metrics namespace, across every
# RunnerCache instance that reports under it (one cache per CompiledProgram
# but ONE "engine.runner_cache.size" gauge) — guarded because executor
# memoization happens on service worker threads
_cache_sizes_lock = threading.Lock()
_cache_sizes: Dict[str, int] = {}


def _cache_size_adjust(name: str, delta: int) -> None:
    with _cache_sizes_lock:
        size = _cache_sizes.get(name, 0) + delta
        _cache_sizes[name] = size
    _metrics.gauge(f"{name}.size").set(size)


class RunnerCache:
    """Bounded LRU store for executor-private memoization.

    ``CompiledProgram._caches`` entries are cheap to rebuild but expensive to
    hold (torch entries pin replay tables in device memory), so
    the cache evicts least-recently-used entries past ``max_entries`` and
    supports ``clear()`` for explicit release — the hook
    :class:`repro_torch.serve.matpim.PlanService` eviction uses. Dict-like surface:
    ``get`` / ``[]=`` / ``pop`` / ``in`` / ``len`` / ``keys`` / ``values``.

    ``on_evict(value)`` fires for every LRU eviction (not for ``pop`` or
    ``clear``) — the service layer reuses this class for its plan cache and
    releases the evicted plan's executor caches there.

    ``metrics`` names a ``repro_torch.obs`` namespace to report under (e.g.
    ``"engine.runner_cache"``): ``<name>.builds[.<kind>]`` counts fresh-key
    inserts (kind = the key's leading tag, so ``builds.torch_fused_plan``
    counts fused replay-plan builds), ``<name>.evictions`` LRU evictions, and the
    ``<name>.size`` gauge tracks live entries aggregated across every cache
    in the namespace — the observable form of the O(programs) claim.
    """

    def __init__(self, max_entries: int = CACHE_MAX_ENTRIES, on_evict=None,
                 metrics: Optional[str] = None):
        self.max_entries = int(max_entries)
        self.evictions = 0
        self.builds = 0
        self._metrics_name = metrics
        self._on_evict = on_evict
        self._d: "OrderedDict[object, object]" = OrderedDict()

    @staticmethod
    def _kind(key) -> str:
        k = key[0] if isinstance(key, tuple) and key else key
        return str(k)

    def get(self, key, default=None):
        if key not in self._d:
            return default
        self._d.move_to_end(key)
        return self._d[key]

    def __getitem__(self, key):
        if key not in self._d:
            raise KeyError(key)
        return self.get(key)

    def __setitem__(self, key, value) -> None:
        fresh = key not in self._d
        self._d[key] = value
        self._d.move_to_end(key)
        if fresh:
            self.builds += 1
            if self._metrics_name is not None:
                _metrics.counter(f"{self._metrics_name}.builds").inc()
                _metrics.counter(
                    f"{self._metrics_name}.builds.{self._kind(key)}").inc()
                _cache_size_adjust(self._metrics_name, 1)
        while len(self._d) > self.max_entries:
            _, old = self._d.popitem(last=False)
            self.evictions += 1
            if self._metrics_name is not None:
                _metrics.counter(f"{self._metrics_name}.evictions").inc()
                _cache_size_adjust(self._metrics_name, -1)
            if self._on_evict is not None:
                self._on_evict(old)

    def pop(self, key, default=None):
        if key in self._d and self._metrics_name is not None:
            _cache_size_adjust(self._metrics_name, -1)
        return self._d.pop(key, default)

    def clear(self) -> None:
        if self._d and self._metrics_name is not None:
            _cache_size_adjust(self._metrics_name, -len(self._d))
        self._d.clear()

    def __del__(self):
        try:
            self.clear()
        except Exception:    # pragma: no cover - interpreter shutdown
            pass

    def __contains__(self, key) -> bool:
        return key in self._d

    def __len__(self) -> int:
        return len(self._d)

    def keys(self):
        return self._d.keys()

    def values(self):
        return self._d.values()


@dataclasses.dataclass
class CompiledProgram:
    """Packed trace of one program on a fixed crossbar geometry.

    Gate-cycle arrays are padded to ``W`` (max gate ops in any cycle;
    ``nops`` holds the real per-cycle count so ragged executors can skip the
    padding) and init cycles to ``I`` rectangles. Padding ops carry the
    all-False mask id 0 and write the sacrificial extra column/row.

    ``schedule`` (attached by :func:`fuse_program`, on by default) is the
    macro-op segment view of the same trace; executors use it when present
    and fall back to per-cycle replay when it is ``None``.
    """

    rows: int
    cols: int
    n_cycles: int
    W: int                     # max gate ops per cycle (padded width)
    I: int                     # max init rectangles per cycle
    mode: np.ndarray           # (T,)      uint8  MODE_COL / MODE_ROW / MODE_INIT
    nops: np.ndarray           # (T,)      int32  real gate ops (0 for init cycles)
    gate: np.ndarray           # (T, W)    int8   GATE_IDS value
    dst: np.ndarray            # (T, W)    int32  output col (col mode) / row (row mode)
    ins: np.ndarray            # (T, W, 5) int32  gather slots (padded w/ const-0 cell)
    sel: np.ndarray            # (T, W)    int32  mask id (row pool in col mode, col pool in row mode)
    init_r: np.ndarray         # (T, I)    int32  row-mask ids
    init_c: np.ndarray         # (T, I)    int32  col-mask ids
    init_v: np.ndarray         # (T, I)    uint8  init values
    row_masks: np.ndarray      # (nR, rows+1) bool
    col_masks: np.ndarray      # (nC, cols+1) bool
    stats: Dict[str, int]      # interpreter-identical op-category counters
    schedule: Optional["FusedSchedule"] = None

    def __post_init__(self):
        # executor-private memoization (bounded LRU, observable through the
        # engine.runner_cache.* metrics — one canonical runner per kind)
        self._caches = RunnerCache(metrics="engine.runner_cache")
        # layout manifest for the kernels backend; algorithm plans attach one
        # at compile time (see plan.CrossbarPlan.compile / core.kernel_exec)
        self.kernel_spec = None

    def clear_caches(self) -> None:
        """Release every memoized executor artifact (replay plans and their
        device-resident index tables). Correctness-neutral: the next
        execute rebuilds on demand. Long-lived services call this when a
        plan leaves their working set."""
        self._caches.clear()

    @property
    def nbytes(self) -> int:
        return sum(
            a.nbytes for a in (self.mode, self.nops, self.gate, self.dst,
                               self.ins, self.sel, self.init_r, self.init_c,
                               self.init_v, self.row_masks, self.col_masks))


# ---------------------------------------------------------------------------
# Macro-op fusion: the static segment schedule
# ---------------------------------------------------------------------------

# sub-split a same-mode run at a width-class change only when both sides keep
# at least this many cycles (prevents fragmentation on alternating widths)
SPLIT_MIN = 32


@dataclasses.dataclass
class Segment:
    """One macro-op segment: ``[t0, t1)`` same-mode cycles, ops re-sorted by
    gate id (stable, so within-gate op order is preserved) and padded to this
    segment's own width ``W`` — typically far narrower than the trace-global
    padding, which is what makes segment replay cheap.

    ``spans`` lists within-segment cycle ranges ``[a, b)`` (relative to
    ``t0``) that are *mutually independent*: no cycle in the span reads or
    rewrites a line written earlier in the span, so the whole span can
    execute as one batched gather → gate-eval → masked-scatter (reads all
    happen against pre-span memory, exactly like the interpreter's
    within-cycle snapshot semantics). ``perm`` maps each sorted op slot back
    to its original compile slot so per-op fault masks stay aligned.
    """

    mode: int
    t0: int
    t1: int
    W: int
    nops: np.ndarray     # (L,)       int32
    gate: np.ndarray     # (L, W)     int8   sorted by gate id per cycle
    dst: np.ndarray      # (L, W)     int32
    ins: np.ndarray      # (L, W, 5)  int32
    sel: np.ndarray      # (L, W)     int32
    perm: np.ndarray     # (L, W)     int32  original slot of sorted slot
    spans: List[Tuple[int, int]]

    @property
    def length(self) -> int:
        return self.t1 - self.t0


@dataclasses.dataclass
class FusedSchedule:
    """Macro-op segment view of a compiled trace.

    Purely a simulator-speed artifact: cycle accounting is untouched
    (``n_cycles`` equals the unfused trace length by construction — asserted
    here and cross-checked by ``latency.compiled_cycles``), and replaying
    segments is bit-identical to per-cycle replay.
    """

    segments: List[Segment]
    n_cycles: int

    def __post_init__(self):
        assert self.n_cycles == sum(s.length for s in self.segments)

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_spans(self) -> int:
        return sum(len(s.spans) for s in self.segments)

    def summary(self) -> Dict[str, int]:
        """Compact shape record (used by the golden-trace fixtures)."""
        return {
            "n_segments": self.n_segments,
            "n_spans": self.n_spans,
            "n_cycles": self.n_cycles,
            "max_W": max((s.W for s in self.segments), default=0),
        }


def _mode_runs(cp: CompiledProgram) -> List[Tuple[int, int, int]]:
    """(mode, t0, t1) maximal same-mode runs, sub-split at width-class
    boundaries when both sides keep >= SPLIT_MIN cycles."""
    runs: List[Tuple[int, int, int]] = []
    T = cp.n_cycles
    t = 0
    while t < T:
        m = int(cp.mode[t])
        t1 = t
        while t1 < T and int(cp.mode[t1]) == m:
            t1 += 1
        bounds = [t]
        if m != MODE_INIT:
            def wclass(x):
                return (max(1, int(cp.nops[x])) - 1).bit_length()
            for u in range(t + 1, t1):
                if (wclass(u) != wclass(u - 1) and u - bounds[-1] >= SPLIT_MIN
                        and t1 - u >= SPLIT_MIN):
                    bounds.append(u)
        bounds.append(t1)
        for a, b in zip(bounds, bounds[1:]):
            runs.append((m, a, b))
        t = t1
    return runs


def _independent_spans(cp: CompiledProgram, t0: int, t1: int) -> List[Tuple[int, int]]:
    """Greedy split of ``[t0, t1)`` into maximal prefixes of mutually
    independent cycles (line-granular, conservative).

    A cycle joins the open span unless one of its ops reads a line written
    earlier in the span (RAW) or writes a line already written (WAW — the
    batched scatter applies at most one masked write per line). Writes to a
    line the span only *read* so far (WAR) are safe: span execution gathers
    all inputs against pre-span memory first, so earlier cycles still see the
    old value — the same snapshot rule the interpreter applies within one
    cycle. Init cycles always span alone (rectangles overlap freely).
    """
    if int(cp.mode[t0]) == MODE_INIT:
        return [(a, a + 1) for a in range(t1 - t0)]
    spans: List[Tuple[int, int]] = []
    a = t0
    written: set = set()
    read: set = set()
    for t in range(t0, t1):
        n = int(cp.nops[t])
        t_ins = {int(v) for v in cp.ins[t, :n].reshape(-1)}
        t_dst = {int(v) for v in cp.dst[t, :n]}
        if t > a and (t_ins & written or t_dst & written):
            spans.append((a - t0, t - t0))
            a, written, read = t, set(), set()
        written |= t_dst
        read |= t_ins
    spans.append((a - t0, t1 - t0))
    return spans


def fuse_program(cp: CompiledProgram) -> FusedSchedule:
    """Group ``cp``'s cycles into macro-op :class:`Segment`\\ s.

    Deterministic (stable sorts only) and cheap — O(trace size) numpy work —
    so it runs by default at compile time. The schedule is attached to
    ``cp.schedule`` by :func:`compile_program`; executors may also call this
    directly for a trace compiled with ``fuse=False``.

    >>> from .isa import ColOp, InitOp
    >>> prog = [[InitOp(slice(None), [0, 1], 0)],
    ...         [ColOp("NOT", (0,), 1, None)],
    ...         [ColOp("NOT", (2,), 3, None)]]
    >>> sched = compile_program(prog, 8, 8, 1, 1).schedule
    >>> sched.n_cycles, sched.n_segments
    (3, 2)
    >>> sched.segments[1].spans      # both NOTs touch disjoint lines
    [(0, 2)]
    """
    segments: List[Segment] = []
    for m, t0, t1 in _mode_runs(cp):
        L = t1 - t0
        if m == MODE_INIT:
            W = 1
            nops = np.zeros(L, np.int32)
            gate = np.zeros((L, W), np.int8)
            dst = np.zeros((L, W), np.int32)
            ins = np.zeros((L, W, MAX_FANIN), np.int32)
            sel = np.zeros((L, W), np.int32)
            perm = np.zeros((L, W), np.int32)
        else:
            W = max(1, int(cp.nops[t0:t1].max()))
            pad_cell = cp.rows if m == MODE_ROW else cp.cols
            nops = np.asarray(cp.nops[t0:t1], np.int32).copy()
            gate = np.zeros((L, W), np.int8)
            dst = np.full((L, W), pad_cell, np.int32)
            ins = np.full((L, W, MAX_FANIN), pad_cell, np.int32)
            sel = np.zeros((L, W), np.int32)
            perm = np.zeros((L, W), np.int32)
            for j, t in enumerate(range(t0, t1)):
                n = int(cp.nops[t])
                order = np.argsort(cp.gate[t, :n], kind="stable")
                gate[j, :n] = cp.gate[t, order]
                dst[j, :n] = cp.dst[t, order]
                ins[j, :n] = cp.ins[t, order]
                sel[j, :n] = cp.sel[t, order]
                perm[j, :n] = order
        segments.append(Segment(
            mode=m, t0=t0, t1=t1, W=W, nops=nops, gate=gate, dst=dst,
            ins=ins, sel=sel, perm=perm,
            spans=_independent_spans(cp, t0, t1)))
    return FusedSchedule(segments=segments, n_cycles=cp.n_cycles)


# ---------------------------------------------------------------------------
# Plan (de)serialization: compiled traces + fused schedules as flat arrays
# ---------------------------------------------------------------------------

# bumped whenever the CompiledProgram/FusedSchedule array layout changes;
# the plan store embeds it so stale on-disk entries load as misses.
# Schema 2 records the executors' canonical packed-word layout (uint32,
# leading W = ceil(B/32) data axis -> ONE batch-polymorphic runner per
# program). The trace arrays themselves are layout-independent, so schema-1
# entries remain loadable (see _ACCEPTED_SCHEMAS).
STATE_SCHEMA = 2
_ACCEPTED_SCHEMAS = (1, STATE_SCHEMA)

# the layout manifest schema-2 entries embed; load-time validation rejects
# an entry claiming a different word width than the executors use
_WORD_LAYOUT = "uint32xW"

# the trace arrays a CompiledProgram is made of, in dataclass order
_CP_ARRAY_FIELDS = ("mode", "nops", "gate", "dst", "ins", "sel",
                    "init_r", "init_c", "init_v", "row_masks", "col_masks")


def schedule_state(sched: FusedSchedule) -> Dict[str, np.ndarray]:
    """Flatten a :class:`FusedSchedule` into named ndarrays.

    Segments concatenate along a single axis per field (`seg_meta` carries
    each segment's ``(mode, t0, t1, W, n_spans)`` so the per-segment slices
    reconstruct from ``L = t1 - t0`` and ``W``); everything is a plain
    integer array — no pickling anywhere in the persistence path.
    """
    segs = sched.segments
    seg_meta = np.array(
        [[s.mode, s.t0, s.t1, s.W, len(s.spans)] for s in segs],
        dtype=np.int64).reshape(len(segs), 5)
    spans = np.array([sp for s in segs for sp in s.spans],
                     dtype=np.int64).reshape(-1, 2)

    def cat(field, dtype):
        parts = [getattr(s, field).reshape(-1) for s in segs]
        return (np.concatenate(parts).astype(dtype, copy=False)
                if parts else np.zeros(0, dtype))

    return {
        "seg_meta": seg_meta,
        "seg_nops": cat("nops", np.int32),
        "seg_gate": cat("gate", np.int8),
        "seg_dst": cat("dst", np.int32),
        "seg_ins": cat("ins", np.int32),
        "seg_sel": cat("sel", np.int32),
        "seg_perm": cat("perm", np.int32),
        "seg_spans": spans,
        "seg_n_cycles": np.int64(sched.n_cycles),
    }


def schedule_from_state(arrays: Dict[str, np.ndarray]) -> FusedSchedule:
    """Rebuild a :class:`FusedSchedule` from :func:`schedule_state` arrays.

    Raises ``ValueError``/``KeyError`` on any layout inconsistency — the
    plan store treats both as a corrupt entry (a cache miss), never as a
    served result.
    """
    seg_meta = np.asarray(arrays["seg_meta"], np.int64).reshape(-1, 5)
    nops_a = np.asarray(arrays["seg_nops"])
    gate_a = np.asarray(arrays["seg_gate"])
    dst_a = np.asarray(arrays["seg_dst"])
    ins_a = np.asarray(arrays["seg_ins"])
    sel_a = np.asarray(arrays["seg_sel"])
    perm_a = np.asarray(arrays["seg_perm"])
    spans_a = np.asarray(arrays["seg_spans"]).reshape(-1, 2)
    # pre-materialize span tuples once: tolist()+zip beats per-element
    # int() over numpy scalars by ~10x, and this loop dominates the
    # restart-path deserialization wall for long conv traces
    span_pairs = list(zip(spans_a[:, 0].tolist(), spans_a[:, 1].tolist()))

    def take(arr, n, shape, off):
        flat = arr[off:off + n]
        if flat.size != n:
            raise ValueError(f"segment array truncated: need {n} past {off}")
        return np.ascontiguousarray(flat.reshape(shape))

    segments: List[Segment] = []
    o1 = o2 = o3 = osp = 0      # offsets: (L,), (L,W), (L,W,5), spans
    for mode, t0, t1, W, nsp in seg_meta.tolist():
        L = t1 - t0
        if L <= 0 or W <= 0 or nsp <= 0:
            raise ValueError(f"bad segment meta L={L} W={W} n_spans={nsp}")
        spans = span_pairs[osp:osp + nsp]
        if len(spans) != nsp:
            raise ValueError("seg_spans truncated")
        segments.append(Segment(
            mode=mode, t0=t0, t1=t1, W=W,
            nops=take(nops_a, L, (L,), o1),
            gate=take(gate_a, L * W, (L, W), o2),
            dst=take(dst_a, L * W, (L, W), o2),
            ins=take(ins_a, L * W * MAX_FANIN, (L, W, MAX_FANIN), o3),
            sel=take(sel_a, L * W, (L, W), o2),
            perm=take(perm_a, L * W, (L, W), o2),
            spans=spans))
        o1 += L
        o2 += L * W
        o3 += L * W * MAX_FANIN
        osp += nsp
    return FusedSchedule(segments=segments,
                         n_cycles=int(arrays["seg_n_cycles"]))


def compiled_state(cp: CompiledProgram) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Split ``cp`` into a JSON-able meta dict + a flat dict of ndarrays.

    The inverse is :func:`compiled_from_state`; together they are the
    persistence surface the reference's ``src/repro/serve/plan_store.py``
    writes as one ``np.savez`` entry. Executor caches (``_caches``) and the
    kernel layout
    manifest are *derived* state and deliberately not serialized — the
    owning plan reattaches them via ``CrossbarPlan.adopt_compiled``.

    >>> from .isa import ColOp, InitOp
    >>> prog = [[InitOp(slice(None), [0, 1], 0)],
    ...         [ColOp("NOT", (0,), 1, None)]]
    >>> cp = compile_program(prog, 8, 8, 1, 1)
    >>> cp2 = compiled_from_state(*compiled_state(cp))
    >>> (cp2.n_cycles, cp2.schedule.n_segments) == (2, 2)
    True
    >>> bool((cp2.ins == cp.ins).all() and cp2.stats == cp.stats)
    True
    """
    meta = {
        "state_schema": STATE_SCHEMA,
        "word_layout": _WORD_LAYOUT,
        "rows": cp.rows, "cols": cp.cols, "n_cycles": cp.n_cycles,
        "W": cp.W, "I": cp.I,
        "stats": {k: int(v) for k, v in cp.stats.items()},
        "fused": cp.schedule is not None,
    }
    arrays = {name: getattr(cp, name) for name in _CP_ARRAY_FIELDS}
    if cp.schedule is not None:
        arrays.update(schedule_state(cp.schedule))
    return meta, arrays


def compiled_from_state(meta: dict,
                        arrays: Dict[str, np.ndarray]) -> CompiledProgram:
    """Rebuild a :class:`CompiledProgram` from :func:`compiled_state` parts.

    Validates the state schema and the core array shapes so a truncated or
    hand-edited blob raises ``ValueError`` instead of constructing a trace
    the executors would misreplay.
    """
    if meta.get("state_schema") not in _ACCEPTED_SCHEMAS:
        raise ValueError(f"compiled-state schema {meta.get('state_schema')!r}"
                         f" not in {_ACCEPTED_SCHEMAS}")
    if meta.get("state_schema") != 1 \
            and meta.get("word_layout") != _WORD_LAYOUT:
        raise ValueError(f"word layout {meta.get('word_layout')!r} "
                         f"!= {_WORD_LAYOUT!r}")
    T, W, I = int(meta["n_cycles"]), int(meta["W"]), int(meta["I"])
    kw = {name: np.ascontiguousarray(arrays[name])
          for name in _CP_ARRAY_FIELDS}
    expect = {"mode": (T,), "nops": (T,), "gate": (T, W), "dst": (T, W),
              "ins": (T, W, MAX_FANIN), "sel": (T, W), "init_r": (T, I),
              "init_c": (T, I), "init_v": (T, I)}
    for name, shape in expect.items():
        if kw[name].shape != shape:
            raise ValueError(
                f"{name} shape {kw[name].shape} != expected {shape}")
    rows, cols = int(meta["rows"]), int(meta["cols"])
    if kw["row_masks"].ndim != 2 or kw["row_masks"].shape[1] != rows + 1:
        raise ValueError(f"row_masks shape {kw['row_masks'].shape}")
    if kw["col_masks"].ndim != 2 or kw["col_masks"].shape[1] != cols + 1:
        raise ValueError(f"col_masks shape {kw['col_masks'].shape}")
    cp = CompiledProgram(
        rows=rows, cols=cols, n_cycles=T, W=W, I=I,
        stats={k: int(v) for k, v in dict(meta["stats"]).items()}, **kw)
    if meta.get("fused"):
        cp.schedule = schedule_from_state(arrays)
        if cp.schedule.n_cycles != cp.n_cycles:
            raise ValueError(
                f"schedule n_cycles {cp.schedule.n_cycles} != {cp.n_cycles}")
    return cp


def compile_program(
    program: Sequence[Sequence[object]],
    rows: int,
    cols: int,
    row_parts: int = 32,
    col_parts: int = 32,
    validate: bool = True,
    fuse: bool = True,
) -> CompiledProgram:
    """Lower ``program`` into a :class:`CompiledProgram` for (rows, cols).

    Raises :class:`SchedulingError` on any cycle the interpreter would have
    rejected (mixed modes, overlapping partition groups, out-of-range cells).
    Empty cycles are skipped, matching ``Crossbar.cycle``. ``fuse=True``
    (default) additionally attaches the macro-op :class:`FusedSchedule`
    (:func:`fuse_program`) that the fast executor paths replay.

    >>> from .isa import ColOp, InitOp
    >>> prog = [[InitOp(slice(None), [0, 1], 0)],
    ...         [ColOp("NOT", (0,), 1, None)]]
    >>> cp = compile_program(prog, 8, 8, 1, 1)
    >>> cp.n_cycles, cp.schedule.n_segments
    (2, 2)
    """
    t0 = time.perf_counter()
    with _span("compile.lower", rows=rows, cols=cols, fuse=fuse) as sp:
        cp = _compile_impl(program, rows, cols, row_parts, col_parts,
                           validate, fuse)
        sp.set(cycles=cp.n_cycles)
    _metrics.counter("compile.programs").inc()
    _metrics.counter("compile.seconds").inc(time.perf_counter() - t0)
    return cp


def _compile_impl(
    program: Sequence[Sequence[object]],
    rows: int,
    cols: int,
    row_parts: int,
    col_parts: int,
    validate: bool,
    fuse: bool,
) -> CompiledProgram:
    assert rows % row_parts == 0 and cols % col_parts == 0
    rp_size, cp_size = rows // row_parts, cols // col_parts
    zero_col, zero_row = cols, rows  # extra always-0 cells

    row_pool, col_pool = _MaskPool(rows), _MaskPool(cols)
    stats = {"col_ops": 0, "row_ops": 0, "init_cycles": 0, "gate_evals": 0}
    # per cycle: (mode, [(gate_id, dst, ins5, sel)], [(rsel, csel, val)])
    lowered: List[Tuple[int, list, list]] = []

    def lower_gate(gate_name: str, inputs: Sequence[int], zero_cell: int):
        gate = GATES[gate_name]
        if gate.arity != len(inputs):
            raise SchedulingError(
                f"{gate_name} arity {gate.arity} != {len(inputs)} inputs")
        ins = list(inputs) + [zero_cell] * (MAX_FANIN - len(inputs))
        return GATE_IDS[gate_name], ins

    for cyc in program:
        if not cyc:
            continue
        kinds = {type(op) for op in cyc}
        if len(kinds) != 1:
            raise SchedulingError(f"mixed op modes in one cycle: {kinds}")
        kind = kinds.pop()

        if kind is InitOp:
            entries = [(row_pool.sel_id(op.rows), col_pool.sel_id(op.cols),
                        int(op.value)) for op in cyc]
            lowered.append((MODE_INIT, [], entries))
            stats["init_cycles"] += 1
        elif kind is ColOp:
            if validate and not groups_disjoint(
                    [col_group(o, cols, cp_size) for o in cyc]):
                raise SchedulingError(
                    "column ops overlap column-partition groups: "
                    + ", ".join(str(col_group(o, cols, cp_size)) for o in cyc))
            ops = []
            for op in cyc:
                gid, ins = lower_gate(op.gate, op.in_cols, zero_col)
                ops.append((gid, op.out_col, ins, row_pool.sel_id(op.rows)))
            lowered.append((MODE_COL, ops, []))
            stats["col_ops"] += len(cyc)
            stats["gate_evals"] += len(cyc)
        elif kind is RowOp:
            if validate and not groups_disjoint(
                    [row_group(o, rows, rp_size) for o in cyc]):
                raise SchedulingError("row ops overlap row-partition groups")
            ops = []
            for op in cyc:
                gid, ins = lower_gate(op.gate, op.in_rows, zero_row)
                ops.append((gid, op.out_row, ins, col_pool.sel_id(op.cols)))
            lowered.append((MODE_ROW, ops, []))
            stats["row_ops"] += len(cyc)
            stats["gate_evals"] += len(cyc)
        else:
            raise SchedulingError(f"unknown op kind {kind}")

    T = len(lowered)
    W = max((len(ops) for _, ops, _ in lowered), default=0) or 1
    I = max((len(ents) for _, _, ents in lowered), default=0) or 1

    mode = np.zeros(T, dtype=np.uint8)
    nops = np.zeros(T, dtype=np.int32)
    gate = np.zeros((T, W), dtype=np.int8)
    dst = np.empty((T, W), dtype=np.int32)
    ins = np.empty((T, W, MAX_FANIN), dtype=np.int32)
    sel = np.zeros((T, W), dtype=np.int32)
    init_r = np.zeros((T, I), dtype=np.int32)
    init_c = np.zeros((T, I), dtype=np.int32)
    init_v = np.zeros((T, I), dtype=np.uint8)

    for t, (m, ops, ents) in enumerate(lowered):
        mode[t] = m
        nops[t] = len(ops)
        pad_cell = zero_row if m == MODE_ROW else zero_col
        dst[t, :] = pad_cell
        ins[t, :, :] = pad_cell
        for w, (gid, d, i5, s) in enumerate(ops):
            gate[t, w] = gid
            dst[t, w] = d
            ins[t, w] = i5
            sel[t, w] = s
        for i, (rs, cs, v) in enumerate(ents):
            init_r[t, i] = rs
            init_c[t, i] = cs
            init_v[t, i] = v

    cp = CompiledProgram(
        rows=rows, cols=cols, n_cycles=T, W=W, I=I,
        mode=mode, nops=nops, gate=gate, dst=dst, ins=ins, sel=sel,
        init_r=init_r, init_c=init_c, init_v=init_v,
        row_masks=row_pool.stack(), col_masks=col_pool.stack(), stats=stats,
    )
    if fuse:
        cp.schedule = fuse_program(cp)
    return cp
