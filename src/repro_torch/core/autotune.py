"""Batch-aware backend autotuner: measured lowering decisions, reused.

The port of ``src/repro/core/autotune.py``. Which concrete backend serves a
compiled trace fastest is a property of the *(program, batch width)* pair,
so the choice is a measurement taken once and reused:

* :func:`program_key` — content-derived key for a compiled trace (geometry,
  cycle count, op stats, segment shape), letter for letter the reference's,
  so the same trace gives the same key in both packages (the plan store's
  integrity check rests on it).
* :func:`batch_bucket` — packed-word buckets ``ceil(B/32)``: every batch
  with the same word count replays through identical executor shapes.
* :class:`TuningTable` — a small on-disk JSON table mapping
  ``(program key, batch bucket, device topology) -> (backend, max_batch,
  us)`` in the reference's file format (schema 3; schema-1/-2 files load
  demoted to *heuristic* entries; corrupt files load as empty).
* :func:`resolve_auto` — what ``engine.execute(backend="auto")`` calls:
  measured entry if present and runnable, heuristic otherwise.
* :func:`autotune_execute` — time the real candidate backends on a real
  run, record the winner, and return its result.

Differences from the reference:

* The backends are the port's (``engine.BACKENDS``). :func:`heuristic`
  picks ``kernels`` for a trace the kernels compute
  (``kernel_exec.kernels_eligible``), else ``torch-fused`` when the trace
  has a schedule, else ``torch-unfused``; under a mesh (``topo > 1``) it
  picks a ``torch`` variant, the only family that shards (the reference's
  choice, not measured against ``kernels`` on the H100).
* The process-default table is named by ``$MATPIM_TORCH_TUNINGS``, not the
  reference's ``$MATPIM_TUNINGS``: rows that name the other package's
  backends are unrunnable here, so a shared file would mix two tables.
* Every timed run ends with its result on the host (``engine.execute``
  copies the final memory back), so an asynchronous ``kernels`` launch is
  timed to its end, not to its return.

Span-chunking rides in as a candidate dimension: ``max_batch=32`` splits a
wide batch into single-word chunks for the replay backends. A ``kernels``
run serves a whole batch in one launch, so it has no chunked candidate.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as _metrics
from ..obs.trace import span as _span

# v2 added the device-topology key component ("key|bucket|topo"); v3 keys
# buckets by canonical word count (ceil(B/32)) instead of pow2 batch width
SCHEMA = 3

# env var naming the port's on-disk tunings table; unset -> in-process only
TUNINGS_ENV = "MATPIM_TORCH_TUNINGS"

# one canonical packed word (engine.WORD_BITS crossbars): the span-chunking
# candidate splits wide batches into chunks of this many crossbars
CHUNK_BATCH = 32


def batch_bucket(B: int) -> int:
    """Packed-word bucket ``ceil(B/32)`` for a batch width (min 1).

    >>> batch_bucket(1), batch_bucket(32), batch_bucket(33), batch_bucket(128)
    (1, 1, 2, 4)
    """
    return max(1, -(-int(B) // 32))


def program_key(cp) -> str:
    """Content-derived tuning key for a compiled trace.

    Built only from trace invariants (geometry, cycle count, padded widths,
    op-category stats, fused segment count), so recompiling the same plan —
    after plan-cache eviction, or in another process — maps back to the same
    tunings row and plan-store integrity key.
    """
    seg = cp.schedule.n_segments if cp.schedule is not None else -1
    stats = ";".join(f"{k}={v}" for k, v in sorted(cp.stats.items()))
    return (f"r{cp.rows}c{cp.cols}t{cp.n_cycles}w{cp.W}i{cp.I}"
            f"s{seg}[{stats}]")


@dataclasses.dataclass
class TuningEntry:
    backend: str                    # concrete backend, e.g. "kernels"
    us: float                       # measured wall per execute (microseconds)
    max_batch: Optional[int] = None  # span-chunking width (None = whole batch)
    source: str = "measured"        # "measured" | "heuristic"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class TuningTable:
    """On-disk ``(program key, batch bucket, topology) -> TuningEntry`` map.

    ``path=None`` keeps the table in-process only. Loading is lazy and
    forgiving: an unreadable / corrupt / unknown-schema file records a
    ``load_error`` and yields an empty table, so ``backend="auto"`` falls
    back to the heuristic instead of failing the execute. Schema-1
    (pre-topology) entries load as topo 1, and schema-1 and -2 buckets are
    re-derived as word buckets (``batch_bucket``; the fastest entry wins
    when several collapse onto one), all demoted to
    ``source="heuristic"``. ``save()`` writes atomically (tmp + rename) and
    creates parent directories.
    """

    def __init__(self, path: Optional[os.PathLike] = None):
        self.path = Path(path) if path is not None else None
        self.load_error: Optional[str] = None
        self._entries: Optional[Dict[Tuple[str, int, int], TuningEntry]] = None

    # -- persistence ---------------------------------------------------------

    def _load(self) -> Dict[Tuple[str, int, int], TuningEntry]:
        if self._entries is not None:
            return self._entries
        self._entries = {}
        if self.path is None or not self.path.exists():
            return self._entries
        try:
            d = json.loads(self.path.read_text())
            schema = d.get("schema")
            if schema not in (1, 2, SCHEMA):
                raise ValueError(f"schema {schema} not in (1, 2, {SCHEMA})")
            for k, e in d["entries"].items():
                if schema == 1:
                    key, bucket = k.rsplit("|", 1)
                    topo, source = 1, "heuristic"  # pre-topology: demote
                else:
                    key, bucket, topo = k.rsplit("|", 2)
                    source = str(e.get("source", "measured"))
                bucket, topo = int(bucket), int(topo)
                if schema < SCHEMA:
                    # legacy pow2 batch bucket -> canonical word bucket;
                    # measured walls predate the layout, so demote
                    bucket, source = batch_bucket(bucket), "heuristic"
                entry = TuningEntry(
                    backend=str(e["backend"]), us=float(e["us"]),
                    max_batch=e.get("max_batch"), source=source)
                if entry.max_batch is not None:
                    entry.max_batch = int(entry.max_batch)
                cur = self._entries.get((key, bucket, topo))
                if cur is None or entry.us < cur.us:  # fastest survivor
                    self._entries[(key, bucket, topo)] = entry
        except Exception as exc:  # corrupt/stale table is never fatal
            self.load_error = f"{type(exc).__name__}: {exc}"
            self._entries = {}
        return self._entries

    def save(self) -> None:
        if self.path is None:
            return
        entries = {f"{k}|{b}|{t}": e.as_dict()
                   for (k, b, t), e in sorted(self._load().items())}
        payload = {"schema": SCHEMA,
                   "generated_by": "repro_torch.core.autotune",
                   "entries": entries}
        self.path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):  # pragma: no cover - rename failed
                os.unlink(tmp)

    # -- queries -------------------------------------------------------------

    def lookup(self, key: str, bucket: int,
               topo: int = 1) -> Optional[TuningEntry]:
        return self._load().get((key, int(bucket), int(topo)))

    def record(self, key: str, bucket: int, backend: str, us: float,
               max_batch: Optional[int] = None,
               source: str = "measured", topo: int = 1) -> TuningEntry:
        e = TuningEntry(backend=backend, us=float(us), max_batch=max_batch,
                        source=source)
        self._load()[(key, int(bucket), int(topo))] = e
        return e

    def observe(self, key: str, bucket: int, backend: str, us: float,
                max_batch: Optional[int] = None, topo: int = 1) -> None:
        """Fold one measured wall time into the table: keep the fastest
        variant seen per (key, bucket, topo); refresh the incumbent's time."""
        cur = self.lookup(key, bucket, topo)
        same = (cur is not None and cur.backend == backend
                and cur.max_batch == max_batch)
        if cur is None or same or cur.source == "heuristic" or us < cur.us:
            self.record(key, bucket, backend, us, max_batch=max_batch,
                        topo=topo)

    def entries(self) -> Dict[Tuple[str, int, int], TuningEntry]:
        return dict(self._load())

    def __len__(self) -> int:
        return len(self._load())


_DEFAULT: Optional[TuningTable] = None
_DEFAULT_PATH: Optional[str] = None


def get_default_table() -> TuningTable:
    """Process-default table; backed by ``$MATPIM_TORCH_TUNINGS`` when set
    (the path is re-checked per call so tests can redirect it), in-memory
    otherwise."""
    global _DEFAULT, _DEFAULT_PATH
    path = os.environ.get(TUNINGS_ENV) or None
    if _DEFAULT is None or path != _DEFAULT_PATH:
        _DEFAULT = TuningTable(path)
        _DEFAULT_PATH = path
    return _DEFAULT


def reset_default_table() -> None:
    """Drop the process-default table (tests)."""
    global _DEFAULT, _DEFAULT_PATH
    _DEFAULT = None
    _DEFAULT_PATH = None


# ---------------------------------------------------------------------------
# Resolution: measured entry if usable, heuristic otherwise
# ---------------------------------------------------------------------------


def _runnable(backend: str) -> bool:
    """Is ``backend`` one of the port's concrete backends?"""
    from .engine import BACKENDS
    return backend in BACKENDS


def heuristic(cp, B: int, topo: int = 1) -> Tuple[str, Optional[int]]:
    """Cold-path choice with nothing measured: ``kernels`` when the kernels
    compute the trace exactly, else fused replay when the trace carries a
    schedule, else per-cycle replay. ``B`` does not change the choice.

    ``topo > 1`` (a usable ``tiles`` mesh under the batch) picks a
    ``torch`` variant whatever the trace: only ``torch`` executes sharded,
    so ``kernels`` would run the topology it was asked to use on one
    device. This is the reference's reasoning, unmeasured on the H100:
    there a two-slot sharded ``torch-fused`` replay on one card ran slower
    than one slot, and ``torch`` replay slower than ``kernels``. A tuned
    entry at that topology overrides it."""
    from .kernel_exec import kernels_eligible
    if kernels_eligible(cp) and topo <= 1:
        return "kernels", None
    return ("torch-fused" if cp.schedule is not None
            else "torch-unfused"), None


def resolve_auto(cp, B: int, faults=None,
                 table: Optional[TuningTable] = None, topo: int = 1
                 ) -> Tuple[str, Optional[int], str]:
    """``backend="auto"`` resolution: ``(backend, max_batch, source)``.

    Fault runs skip the table entirely: they replay on ``torch``, and
    fault-injected walls never train the table. ``topo`` keys the lookup
    by device topology, so a 1-device measurement never decides a sharded
    execute (and vice versa).
    """
    if faults is not None:
        _metrics.counter("autotune.resolve.faults").inc()
        return "torch", None, "faults"
    table = table if table is not None else get_default_table()
    e = table.lookup(program_key(cp), batch_bucket(B), topo=topo)
    if e is not None and e.source == "measured" and _runnable(e.backend):
        _metrics.counter("autotune.resolve.measured").inc()
        return e.backend, e.max_batch, "measured"
    if e is not None and _runnable(e.backend) and topo == 1:
        # demoted legacy entry: a usable hint, still reported as heuristic
        _metrics.counter("autotune.resolve.heuristic").inc()
        return e.backend, e.max_batch, "heuristic"
    be, mb = heuristic(cp, B, topo=topo)
    _metrics.counter("autotune.resolve.heuristic").inc()
    return be, mb, "heuristic"


# ---------------------------------------------------------------------------
# Measurement: time real runs, record the winner
# ---------------------------------------------------------------------------


def candidates(cp, B: int, cheap: bool = False
               ) -> List[Tuple[str, Optional[int]]]:
    """Candidate ``(backend, max_batch)`` pairs for a batch width.

    ``cheap=True`` (the serving layer's inline tune) drops
    ``torch-unfused`` on a trace with a schedule: its per-cycle replay
    issues the most device calls of any candidate, so it is the slowest
    probe to time.
    """
    from .kernel_exec import kernels_eligible
    replay = ["torch-fused"]
    if not cheap or cp.schedule is None:
        replay.append("torch-unfused")
    cand: List[Tuple[str, Optional[int]]] = [(be, None) for be in replay]
    if B > CHUNK_BATCH:  # span-chunking: word-width chunks of a wide batch
        cand += [(be, CHUNK_BATCH) for be in replay]
    if kernels_eligible(cp):
        cand.append(("kernels", None))
    return cand


def autotune_execute(cp, mems, table: Optional[TuningTable] = None,
                     reps: int = 2, cheap: bool = True, save: bool = True,
                     device="cuda"):
    """Time every candidate on the given batch, record the fastest, return
    ``(EngineResult of the winner, TuningEntry)``.

    The probe runs ARE real executions (all candidates are bit-identical by
    the conformance contract), so the caller keeps the winner's result. Each
    timed run ends with the final memory on the host, so the card's work is
    inside the window.
    """
    import numpy as np

    from .engine import execute

    mems = np.asarray(mems)
    B = mems.shape[0] if mems.ndim == 3 else 1
    table = table if table is not None else get_default_table()
    best = None
    with _span("autotune.tune", key=program_key(cp),
               bucket=batch_bucket(B)) as tune_sp:
        for be, mb in candidates(cp, B, cheap=cheap):
            with _span("autotune.probe", backend=be, max_batch=mb) as sp:
                res = execute(cp, mems, backend=be, device=device,
                              max_batch=mb)  # warm
                us = None
                for _ in range(max(1, reps)):
                    t0 = time.perf_counter()
                    res = execute(cp, mems, backend=be, device=device,
                                  max_batch=mb)
                    dt = (time.perf_counter() - t0) * 1e6
                    us = dt if us is None else min(us, dt)
                sp.set(us=us)
            _metrics.counter("autotune.probes").inc()
            if best is None or us < best[0]:
                best = (us, be, mb, res)
        us, be, mb, res = best
        tune_sp.set(winner=be, us=us)
    _metrics.counter(f"autotune.wins.{be}" + (f"@{mb}" if mb else "")).inc()
    entry = table.record(program_key(cp), batch_bucket(B), be, us,
                         max_batch=mb)
    if save:
        table.save()
    return res, entry


__all__ = [
    "CHUNK_BATCH", "TuningEntry", "TuningTable", "autotune_execute",
    "batch_bucket", "candidates", "get_default_table", "heuristic",
    "program_key", "reset_default_table", "resolve_auto",
]
