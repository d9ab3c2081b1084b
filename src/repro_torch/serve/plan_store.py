"""Persistent on-disk plan cache: compiled traces survive process restarts.

The port of ``src/repro/serve/plan_store.py``. The serving layer's cold
cost is re-deriving state that is a pure function of the plan key —
lowering the program to a packed trace and fusing the macro-op schedule.
This module persists both as one ``.npz`` file per plan, so a restarted
:class:`repro_torch.serve.matpim.PlanService` built on the same store path
serves its first batch with **zero** ``compile_program`` calls.

Storage contract (the reference's, entry for entry)
---------------------------------------------------
* One entry per plan: ``<sha256(repr(plan_key))[:32]>.npz`` under the store
  root. The full ``repr`` is also embedded in the entry and verified on
  load, so a digest collision can only ever cost a recompile.
* Entries are ``np.savez`` archives (``allow_pickle=False`` on both ends)
  holding the flat arrays from ``core.compile.compiled_state`` plus a
  ``__meta__`` uint8 array carrying the JSON meta: store schema tag, the
  plan-key repr, the trace's ``core.autotune.program_key`` (recomputed
  after deserialization as an integrity check), and the compiled-state
  meta. An entry the reference wrote loads here under the same key.
* Writes are atomic: ``tempfile.mkstemp`` in the store directory, then
  ``os.replace``.
* **Any** load problem — missing file, truncated zip, schema bump, key or
  program-key mismatch — is a miss, never an error: corrupt entries are
  counted, unlinked best-effort, and recompiled over.

The reference also points JAX's persistent compilation cache at
``<store>/xla`` (``_point_jax_cache``). The port has no counterpart: its
executors build their device tables at first use and its kernels are built
by ``nvcc`` into ``build/repro_torch/`` (see :mod:`repro_torch.kernels`),
so only the traces are persisted.

``$MATPIM_TORCH_PLAN_STORE`` names the port's default store path (not the
reference's ``$MATPIM_PLAN_STORE``); when unset, services run store-less
unless handed a :class:`PlanStore` explicitly.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..core import autotune as _autotune
from ..core.compile import (CompiledProgram, compiled_from_state,
                            compiled_state)
from ..obs import metrics as _metrics
from ..obs.trace import span as _span

SCHEMA = 1

# env var naming the port's default on-disk plan store; unset -> none
STORE_ENV = "MATPIM_TORCH_PLAN_STORE"

__all__ = ["PlanStore", "STORE_ENV", "get_default_store",
           "reset_default_store", "store_key"]


def store_key(plan_key: object) -> str:
    """Stable filename digest for a service plan key.

    >>> store_key(("binary_matvec", (8, 16))) == \
        store_key(("binary_matvec", (8, 16)))
    True
    >>> len(store_key("anything"))
    32
    """
    return hashlib.sha256(repr(plan_key).encode()).hexdigest()[:32]


class PlanStore:
    """One directory of serialized compiled plans.

    Load/put are thread-safe by construction (independent files, unique tmp
    names): the compile pool calls them from worker threads without locks.
    """

    def __init__(self, path: os.PathLike):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.corrupt = 0
        self.puts = 0
        self.put_errors = 0
        self.last_error: Optional[str] = None

    # -- paths ---------------------------------------------------------------

    def entry_path(self, plan_key: object) -> Path:
        return self.path / f"{store_key(plan_key)}.npz"

    def keys(self) -> List[str]:
        """Digests of every visible entry (in-flight tmp files excluded)."""
        return sorted(p.stem for p in self.path.glob("*.npz")
                      if not p.name.startswith(".tmp-"))

    def __len__(self) -> int:
        return len(self.keys())

    # -- load / put ----------------------------------------------------------

    def load(self, plan_key: object) -> Optional[CompiledProgram]:
        """Deserialize the entry for ``plan_key``; ``None`` on any miss."""
        p = self.entry_path(plan_key)
        if not p.exists():
            self.misses += 1
            _metrics.counter("serve.store.misses").inc()
            return None
        try:
            with _span("store.load", key=p.stem):
                with np.load(p, allow_pickle=False) as z:
                    meta = json.loads(bytes(z["__meta__"]).decode())
                    if meta.get("store_schema") != SCHEMA:
                        raise ValueError(
                            f"store schema {meta.get('store_schema')!r} "
                            f"!= {SCHEMA}")
                    if meta.get("plan_key") != repr(plan_key):
                        raise ValueError("plan-key mismatch (digest "
                                         "collision or renamed entry)")
                    arrays = {k: z[k] for k in z.files if k != "__meta__"}
                cp = compiled_from_state(meta["compiled"], arrays)
                if _autotune.program_key(cp) != meta.get("program_key"):
                    raise ValueError("program_key integrity check failed")
        except Exception as e:
            # truncated zip, stale schema, bad shapes, key mismatch: all
            # load as misses — a store can never fail a request
            self.corrupt += 1
            self.misses += 1
            self.last_error = f"{p.name}: {e}"
            _metrics.counter("serve.store.corrupt").inc()
            _metrics.counter("serve.store.misses").inc()
            try:
                p.unlink()
            except OSError:
                pass
            return None
        self.hits += 1
        _metrics.counter("serve.store.hits").inc()
        return cp

    def put(self, plan_key: object, cp: CompiledProgram) -> bool:
        """Serialize ``cp`` under ``plan_key`` (atomic tmp + rename)."""
        cmeta, arrays = compiled_state(cp)
        meta = {
            "store_schema": SCHEMA,
            "plan_key": repr(plan_key),
            "program_key": _autotune.program_key(cp),
            "compiled": cmeta,
        }
        blob = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                             dtype=np.uint8)
        fd, tmp = tempfile.mkstemp(dir=self.path, prefix=".tmp-",
                                   suffix=".npz")
        try:
            with _span("store.put", key=store_key(plan_key)):
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, __meta__=blob, **arrays)
                os.replace(tmp, self.entry_path(plan_key))
        except Exception as e:
            self.put_errors += 1
            self.last_error = str(e)
            _metrics.counter("serve.store.put_errors").inc()
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self.puts += 1
        _metrics.counter("serve.store.puts").inc()
        return True


# ---------------------------------------------------------------------------
# Process default ($MATPIM_TORCH_PLAN_STORE)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[PlanStore] = None
_DEFAULT_PATH: Optional[str] = None


def get_default_store() -> Optional[PlanStore]:
    """The ``$MATPIM_TORCH_PLAN_STORE`` store, or ``None`` when the env is
    unset. Re-checks the environment on every call (mirroring
    ``autotune.get_default_table``); the store object is reused while the
    path is unchanged."""
    global _DEFAULT, _DEFAULT_PATH
    path = os.environ.get(STORE_ENV)
    if not path:
        return None
    if _DEFAULT is None or _DEFAULT_PATH != path:
        _DEFAULT = PlanStore(path)
        _DEFAULT_PATH = path
    return _DEFAULT


def reset_default_store() -> None:
    """Forget the cached default store (tests)."""
    global _DEFAULT, _DEFAULT_PATH
    _DEFAULT = None
    _DEFAULT_PATH = None
