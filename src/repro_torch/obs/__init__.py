"""Zero-dependency telemetry for the PyTorch port.

A copy of ``src/repro/obs/``.

* :mod:`repro_torch.obs.trace` — contextvar-propagated span tracer with
  Chrome-trace/Perfetto JSON export; disabled by default (``$MATPIM_TRACE``
  or :func:`~repro_torch.obs.trace.enable` turn it on).
* :mod:`repro_torch.obs.metrics` — process-wide registry of counters,
  gauges and fixed-bucket histograms with quantile readout.

Both are stdlib-only. The port keeps its own copy so it never imports the
reference package.
"""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry, registry,
                      reset_metrics, snapshot)
from .trace import (Tracer, disable, enable, enabled, get_tracer, save,
                    span)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Tracer",
    "disable", "enable", "enabled", "get_tracer", "registry",
    "reset_metrics", "save", "snapshot", "span",
]
