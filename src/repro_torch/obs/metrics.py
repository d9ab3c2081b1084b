"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The reference's ``src/repro/obs/metrics.py``, kept as the port's own
(stdlib only).

Unlike the span tracer, metrics are **always on**: an update is one dict
lookup plus an integer/float add, cheap enough for every ``engine.execute``
call and every token the serving engine samples. The registry is the
single source the serving layers, the autotuner and the engines publish
into; :func:`snapshot` renders it as a stable (sorted, JSON-serializable)
dict.

Metric names are dotted paths with the owning layer first
(``serve.request_latency_us``, ``engine.execute.wall_us.numpy-fused``,
``autotune.resolve.measured``, ``engine.tokens``,
``engine.host_copy_bytes``, …); the reference's catalog is in
``docs/ARCHITECTURE.md`` §Observability.

Histograms use fixed 1-2-5 geometric bucket bounds (µs-scaled by default),
so quantile readout is a cumulative-count walk with linear interpolation
inside the winning bucket — no sample retention, O(1) memory under
sustained load.

>>> reg = MetricsRegistry()
>>> reg.counter("serve.cache.hits").inc()
>>> reg.counter("serve.cache.hits").inc(2)
>>> reg.counter("serve.cache.hits").value
3
>>> reg.gauge("serve.queue_depth_units").set(7)
>>> h = reg.histogram("lat_us")
>>> for v in range(1, 101): h.observe(v)
>>> h.count, 40.0 <= h.quantile(0.5) <= 60.0
(100, True)
>>> snap = reg.snapshot()
>>> snap["serve.cache.hits"], snap["serve.queue_depth_units"]
({'type': 'counter', 'value': 3}, {'type': 'gauge', 'value': 7})
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, Optional, Sequence, Union

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "counter", "gauge",
    "histogram", "registry", "reset_metrics", "snapshot",
]

Number = Union[int, float]


class Counter:
    """Monotonically increasing value (int or float increments)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def as_dict(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-written value (queue depth, fault rate, …)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value: Optional[Number] = None

    def set(self, v: Number) -> None:
        self.value = v

    def as_dict(self) -> dict:
        return {"type": "gauge", "value": self.value}


def _default_bounds() -> List[float]:
    # 1-2-5 geometric series over 1 µs .. 1e8 µs (100 s): 25 finite buckets
    # + underflow/overflow. Wide enough for wall times from a span() call
    # to a cold conv compile.
    out = []
    for exp in range(9):
        for m in (1, 2, 5):
            out.append(m * 10.0 ** exp)
    return out


class Histogram:
    """Fixed-bucket histogram with interpolated quantile readout.

    ``bounds`` are the finite upper edges; observations land in the first
    bucket whose edge is >= the value (plus one overflow bucket). Exact
    ``count``/``sum``/``min``/``max`` ride along, so means stay exact and
    quantiles are only bucket-resolution approximations.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "vmin", "vmax")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds = sorted(float(b) for b in (bounds or _default_bounds()))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: Number) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (linear interpolation inside the bucket,
        clamped to the observed min/max; 0.0 with no observations)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q={q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.bounds[i - 1] if i > 0 else min(self.vmin, 0.0)
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                frac = (target - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.vmin), self.vmax)
            seen += c
        return self.vmax  # pragma: no cover - unreachable (counts sum)

    def as_dict(self) -> dict:
        d = {"type": "histogram", "count": self.count, "sum": self.sum,
             "mean": self.mean}
        if self.count:
            d.update(min=self.vmin, max=self.vmax,
                     p50=self.quantile(0.5), p95=self.quantile(0.95),
                     p99=self.quantile(0.99))
        return d


class MetricsRegistry:
    """Name → metric map with get-or-create accessors.

    Re-fetching a name returns the same object; fetching it as a different
    metric type is a bug and raises. ``snapshot()`` is sorted by name, so
    its JSON form is stable across runs with the same instrumentation.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(*args)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested as {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None) -> Histogram:
        # bounds apply on first registration only; later fetches reuse them
        return self._get(name, Histogram, bounds)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        return {name: self._metrics[name].as_dict()
                for name in sorted(self._metrics)}

    def reset(self) -> None:
        self._metrics.clear()

    def __len__(self) -> int:
        return len(self._metrics)


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every instrumented layer publishes into."""
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str,
              bounds: Optional[Sequence[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, bounds)


def snapshot() -> Dict[str, dict]:
    return _REGISTRY.snapshot()


def reset_metrics() -> None:
    """Clear the process-wide registry (tests, bench isolation)."""
    _REGISTRY.reset()
