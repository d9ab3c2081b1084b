"""Zero-dependency telemetry for the PyTorch port.

The same modules as the reference's ``src/repro/obs/``, kept as the
port's own so that it never imports the reference package.

* :mod:`repro_torch.obs.trace` — contextvar-propagated span tracer with
  Chrome-trace/Perfetto JSON export; disabled by default (``$MATPIM_TRACE``
  or :func:`~repro_torch.obs.trace.enable` turn it on).
* :mod:`repro_torch.obs.metrics` — process-wide registry of counters,
  gauges and fixed-bucket histograms with quantile readout.

Both are stdlib-only. PlanService's path (``serve.*``, ``engine.execute``,
``compile.*``, ``autotune.*``) and the model path publish into them. The
model path's spans are ``engine.admit`` (``.handoff``, ``.first_token``),
``engine.step`` (``.fetch``, ``.sample``) in ``serve/engine.py`` and
``model.forward``, ``model.decode_step`` and one ``model.group`` per layer
group in ``models/lm.py`` (a decode step replayed from its CUDA graph
records one ``model.decode_step`` with ``graph=1`` and nothing inside
it), each Mamba-2 mixer's ``model.mamba``
(``tokens``, ``tail``: the rows of a ragged last SSD chunk) inside its
group and ``mamba.ssd`` (``tokens``, ``pad_rows``) around its chunked scan
(``models/mamba.py``); its counters are ``engine.tokens``,
``engine.host_copy_bytes``, ``mamba.ssd.tokens``, ``mamba.ssd.pad_rows``,
``mamba.decode.state_copy_bytes`` (the conv and SSM states a decode
step copies back into the engine's cache), and ``model.decode.graph`` /
``model.decode.eager`` (the engine's decode steps replayed from its graph
and run eagerly).
``tests/test_torch_serve_engine.py`` holds that span tree, the counters
and the disabled tracer (no event recorded, the same tokens) on the CPU
and runs both modules' examples; ``tests/test_torch_granite_hybrid.py``
the Mamba-2 spans and counters;
``tests/test_torch_faults.py`` holds the crossbar engine's fault counters,
gauges and spans.
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
