"""Contextvar-propagated span tracer with Chrome-trace/Perfetto export.

The reference's ``src/repro/obs/trace.py``, kept as the port's own
(stdlib only).

Instrumented code calls :func:`span` around a timed region:

    with span("serve.flush", pending=3):
        ...

Spans nest lexically within a thread/context — the contextvar carries the
current depth, so spans opened inside other spans are recorded as children
(Perfetto reconstructs the hierarchy from time containment per thread
track). The recorded events are Chrome-trace *complete* events (``"ph":
"X"`` with microsecond ``ts``/``dur``), the format both ``chrome://tracing``
and https://ui.perfetto.dev load directly.

Cost model — this module is imported by the hot paths (the crossbar
engine's ``engine.execute``; the serving engine's ``engine.admit`` and
``engine.step``; the model's ``model.forward``, ``model.decode_step`` and
``model.group``, sixteen a call for olmo-1b), so the **disabled** path is a
module-global boolean check plus returning a no-op singleton context
manager (no allocation, no clock read). ``tests/test_torch_serve_engine.py``
checks that it records no event and leaves the served tokens as they are.
Tracing only pays for clock reads and one dict append per span when
enabled.

Enabling: programmatic :func:`enable`/:func:`disable`, or set
``$MATPIM_TRACE`` before import — the value ``1`` just enables, any other
value is treated as an output path written at interpreter exit.

>>> tr = enable()
>>> with span("outer"):
...     with span("inner", step=1):
...         pass
>>> _ = disable()
>>> [e["name"] for e in tr.chrome_trace()["traceEvents"]]
['inner', 'outer']
>>> sorted(tr.chrome_trace()["traceEvents"][0]) == \
    ['args', 'dur', 'name', 'ph', 'pid', 'tid', 'ts']
True
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from typing import List, Optional

__all__ = [
    "Tracer", "disable", "enable", "enabled", "get_tracer", "save", "span",
]

# fast-path guard: read on every span() call, flipped only by enable/disable
_ENABLED = False
_TRACER: Optional["Tracer"] = None

# per-context span nesting depth (recorded into event args; Perfetto itself
# nests by time containment, the depth makes flat consumers' lives easier)
_DEPTH: contextvars.ContextVar = contextvars.ContextVar(
    "matpim_span_depth", default=0)


class _NullSpan:
    """Singleton no-op span: the entire disabled-path cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class Span:
    """One live span; records a complete event into its tracer on exit."""

    __slots__ = ("name", "args", "_t0", "_tok", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        self._tok = _DEPTH.set(_DEPTH.get() + 1)
        self._t0 = time.perf_counter_ns()
        return self

    def set(self, **attrs) -> "Span":
        """Attach attributes discovered mid-span (e.g. a resolved backend)."""
        self.args.update(attrs)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _DEPTH.reset(self._tok)
        self._tracer._emit(self.name, self._t0, t1, _DEPTH.get(), self.args)
        return False


class Tracer:
    """Event sink for one tracing session.

    Events accumulate in memory (one small dict per span — list appends are
    atomic under the GIL, so concurrently-traced threads interleave safely)
    until :meth:`save`/:meth:`chrome_trace`.
    """

    def __init__(self):
        self.t0_ns = time.perf_counter_ns()
        self.pid = os.getpid()
        self._events: List[dict] = []

    def _emit(self, name: str, t0_ns: int, t1_ns: int, depth: int,
              args: dict) -> None:
        self._events.append({
            "name": name,
            "ph": "X",
            "ts": (t0_ns - self.t0_ns) / 1e3,       # µs, Chrome-trace unit
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": self.pid,
            "tid": threading.get_ident(),
            "args": {"depth": depth, **args},
        })

    def __len__(self) -> int:
        return len(self._events)

    def events(self) -> List[dict]:
        return list(self._events)

    def chrome_trace(self) -> dict:
        """The JSON-object trace form Perfetto/chrome://tracing load."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def save(self, path: os.PathLike) -> None:
        """Write the Chrome-trace JSON (parent dirs created)."""
        p = os.fspath(path)
        d = os.path.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(p, "w") as f:
            json.dump(self.chrome_trace(), f)
            f.write("\n")


def enabled() -> bool:
    return _ENABLED


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or ``None`` when tracing is disabled."""
    return _TRACER


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Turn tracing on (idempotent); returns the active tracer."""
    global _ENABLED, _TRACER
    if tracer is not None:
        _TRACER = tracer
    elif _TRACER is None or not _ENABLED:
        _TRACER = Tracer()
    _ENABLED = True
    return _TRACER


def disable() -> Optional[Tracer]:
    """Turn tracing off; returns the tracer (with its events) if one ran."""
    global _ENABLED, _TRACER
    tr, _TRACER = _TRACER, None
    _ENABLED = False
    return tr


def save(path: os.PathLike) -> bool:
    """Save the active tracer's events to ``path``; False when disabled."""
    if _TRACER is None:
        return False
    _TRACER.save(path)
    return True


def span(name: str, **args):
    """Open a traced span (context manager).

    The disabled path returns a shared no-op object — callers never need to
    guard instrumentation sites themselves.
    """
    if not _ENABLED:
        return _NULL_SPAN
    return Span(_TRACER, name, args)


# $MATPIM_TRACE: enable at import; any value other than "1" is the output
# path, flushed at interpreter exit
_env = os.environ.get("MATPIM_TRACE")
if _env and _env != "0":
    enable()
    if _env != "1":
        import atexit

        atexit.register(lambda path=_env: save(path))
del _env
