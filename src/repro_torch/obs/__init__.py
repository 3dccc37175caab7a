"""repro_torch.obs — zero-perturbation observability: tracing, metrics,
Perfetto/Prometheus export; the port of ``repro.obs``.

Every runtime subsystem of the port (both simulator engines, the queueing
layer, the Pareto planner, the online oracle and its registry, both
serving engines) accepts an ``obs=`` tracer and emits

  * per-task lifecycle **spans** (``sojourn ⊃ queue_wait · service ·
    transfer``), one track per node/pool, stamped in virtual time inside
    :mod:`repro_torch.sim` and wall time in :mod:`repro_torch.serve`;
  * **instant events** for the control plane: replans, split re-picks,
    pool saturation, Page–Hinkley drift triggers, oracle refits, registry
    publishes;
  * **metrics** via :class:`MetricsRegistry` — counters, gauges,
    fixed-boundary histograms and quantile sketches, with a Prometheus
    text dump (``ServeEngine(metrics=)``, ``Telemetry.registry()``).

The default :data:`NULL_TRACER` no-ops every hook, and a live
:class:`Tracer` only observes values the engines already compute, so
traced runs compute the same records and tokens as untraced ones
(``tests/test_torch_obs.py``).  The tracer works on host data: columns a
caller hands over as tensors come home once per column, at the first
read.

Export: :func:`export_chrome` writes Chrome trace-event JSON loadable in
Perfetto; :func:`validate_chrome` is the span-pairing checker;
``Tracer.last(n)`` is the flight recorder :func:`postmortem_dump` writes
when an event loop fails.  The consumption layer is
:mod:`repro_torch.obs.analyze` (attribution, diff, quantile sketches, the
``regress`` gate; ``python -m repro_torch.obs.analyze``).
"""
from repro_torch.obs.chrome import export_chrome, validate_chrome
from repro_torch.obs.metrics import (LATENCY_BOUNDARIES, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, InstantEvent, NullTracer,
                                   SpanEvent, Tracer, postmortem_dump)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "SpanEvent", "InstantEvent",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BOUNDARIES", "export_chrome", "validate_chrome",
    "postmortem_dump", "QuantileSketch",
]


def __getattr__(name):
    # QuantileSketch lives in the analyze layer above metrics; a lazy
    # attribute keeps `from repro_torch.obs import QuantileSketch` working
    # without importing the consumption layer eagerly
    if name == "QuantileSketch":
        from repro_torch.obs.analyze.sketch import QuantileSketch
        return QuantileSketch
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
