"""repro_torch.obs.analyze — the consumption layer over the trace/metrics
substrate: turn recorded spans into answers.

:mod:`repro_torch.obs` (the layer below) records with zero perturbation;
this package reads what it recorded:

  * :func:`attribute` / :class:`RunAttribution` — per-task and per-run
    phase attribution (``sojourn = queue_wait + service + transfer``),
    critical paths, and the deadline-miss classifier
    (:mod:`~repro_torch.obs.analyze.attribution`);
  * :func:`diff` — differential profiling of two runs: per-phase
    quantile deltas, K-S statistics, top-k regressed tasks
    (:mod:`~repro_torch.obs.analyze.diff`);
  * :class:`QuantileSketch` — mergeable fixed-centroid streaming
    quantiles; also a :class:`repro_torch.obs.MetricsRegistry` kind via
    ``registry.quantile(name)`` (:mod:`~repro_torch.obs.analyze.sketch`);
  * :func:`compare_rows` / the ``regress`` CLI — baseline regression
    gating for CI (:mod:`~repro_torch.obs.analyze.regress`).

CLI: ``python -m repro_torch.obs.analyze {attribution,diff,regress} ...``.

Import note: :mod:`repro_torch.obs.metrics` lazily imports
:class:`QuantileSketch` *inside* ``MetricsRegistry.quantile`` — keep
this package's module-scope imports pointed at sibling submodules only
so that deferral never re-enters a half-initialised ``repro_torch.obs``.
"""
from repro_torch.obs.analyze.attribution import (MISS_CAUSES,
                                                 RunAttribution, attribute)
from repro_torch.obs.analyze.diff import (DiffReport, PhaseDiff, diff,
                                          ks_statistic)
from repro_torch.obs.analyze.regress import (RegressionReport,
                                             compare_files, compare_rows,
                                             load_rows, selftest)
from repro_torch.obs.analyze.sketch import DEFAULT_QUANTILES, QuantileSketch
from repro_torch.obs.analyze.tables import (PHASES, TaskTable, TraceTable,
                                            load)

__all__ = [
    "attribute", "RunAttribution", "MISS_CAUSES",
    "diff", "DiffReport", "PhaseDiff", "ks_statistic",
    "compare_rows", "compare_files", "load_rows", "selftest",
    "RegressionReport",
    "QuantileSketch", "DEFAULT_QUANTILES",
    "TraceTable", "TaskTable", "load", "PHASES",
]
