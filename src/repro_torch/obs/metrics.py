"""Metrics registry: counters, gauges, fixed-boundary histograms, and
Prometheus text exposition — the port of ``repro.obs.metrics``, host
numpy in the reference's order, so its text and rows are the reference's.

:class:`MetricsRegistry` is the standard metrics surface the ROADMAP's
production serving plane scrapes and autoscales against — the
structured superset of the ad-hoc ``Counter``/``gauges`` dicts
:class:`repro_torch.sim.telemetry.Telemetry` accumulated historically
(``Telemetry.registry()`` lifts a run's counters, gauges, and
sojourn/wait/transfer distributions into one, and
``Telemetry.to_prometheus()`` dumps it).

Four metric kinds, deliberately matching the Prometheus data model:

``Counter``
    monotone float total (``inc``); exposed as ``# TYPE ... counter``.
``Gauge``
    last-write-wins float (``set`` / ``inc``); ``# TYPE ... gauge``.
``Histogram``
    fixed-boundary cumulative-bucket histogram (``observe`` /
    ``observe_many``); boundaries are chosen at construction —
    :data:`LATENCY_BOUNDARIES` covers the sojourn/wait/transfer scales
    the simulators produce — so :meth:`Histogram.merge` and scraping
    never re-bin.
``summary``
    a live :class:`repro_torch.obs.analyze.QuantileSketch`
    (:meth:`MetricsRegistry.quantile`): mergeable fixed-centroid
    streaming quantiles — rolling p50/p99 without stored samples,
    exposed as a Prometheus summary series.

:meth:`MetricsRegistry.to_prometheus` renders the text exposition
format (``HELP``/``TYPE`` comments, ``_bucket``/``_sum``/``_count``
histogram series with cumulative ``le`` labels, ``+Inf`` bucket);
:meth:`MetricsRegistry.to_rows` renders the same data in the flat
``[{"name": ..., metric: ...}]`` record schema the ``results/``
benchmark JSONs use, so one plotting path covers both.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LATENCY_BOUNDARIES"]

#: default seconds-scale boundaries for sojourn / wait / transfer
#: histograms: ~1 ms to ~2 min in roughly-2.5x steps
LATENCY_BOUNDARIES = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                      0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def host_f64(values) -> np.ndarray:
    """``values`` as a flat f64 numpy array.  A tensor, on any device and
    of any float or integer dtype, comes to the host in one copy (its
    values widened to f64 first, which is exact), never element by
    element."""
    if isinstance(values, torch.Tensor):
        values = values.detach().to("cpu", torch.float64).numpy()
    return np.asarray(values, np.float64).ravel()


def _fmt(v: float) -> str:
    """Prometheus sample formatting: integers render bare."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


@dataclasses.dataclass
class Counter:
    """Monotone total."""
    name: str
    help: str = ""
    value: float = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        self.value += n

    def expose(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    kind = "counter"


@dataclasses.dataclass
class Gauge:
    """Last-write-wins value."""
    name: str
    help: str = ""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def expose(self) -> list[str]:
        return [f"{self.name} {_fmt(self.value)}"]

    kind = "gauge"


class Histogram:
    """Fixed-boundary histogram with cumulative Prometheus buckets.

    ``boundaries`` are the upper bounds of the finite buckets (strictly
    increasing); an implicit ``+Inf`` bucket catches the rest.  Counts,
    sum, and count are plain floats/ints — ``observe_many`` takes a
    vector (a list, an array, or a tensor on any device, brought home in
    one copy) so a run's whole sojourn column lands in one
    ``searchsorted`` rather than a Python loop per task.
    """

    kind = "histogram"

    def __init__(self, name: str, boundaries: Sequence[float] =
                 LATENCY_BOUNDARIES, help: str = ""):
        self.name = name
        self.help = help
        b = tuple(float(x) for x in boundaries)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram {name}: boundaries must be "
                             f"non-empty and strictly increasing, "
                             f"got {b}")
        self.boundaries = b
        self._bounds = np.asarray(b, np.float64)
        self.counts = np.zeros(len(b) + 1, np.int64)  # [+Inf] last
        self.sum = 0.0
        self.count = 0
        self.observed_max = float("-inf")

    def observe(self, v: float) -> None:
        self.observe_many([v])

    def observe_many(self, values) -> None:
        v = host_f64(values)
        if v.size == 0:
            return
        # bucket k holds values <= boundaries[k] (Prometheus `le`)
        idx = np.searchsorted(self._bounds, v, side="left")
        self.counts += np.bincount(idx, minlength=len(self.counts))
        self.sum += float(v.sum())
        self.count += int(v.size)
        self.observed_max = max(self.observed_max, float(v.max()))

    def percentile_bound(self, q: float) -> float:
        """Upper bound on the q-quantile recoverable without raw
        samples: the upper boundary of the bucket the quantile falls
        in.  Always *finite*: when the quantile lands in the ``+Inf``
        bucket the exact observed maximum is returned instead (a
        histogram that answered ``inf`` is useless to an autoscaler).
        ``q`` below the observed mass clamps to the bucket holding the
        smallest observation (``q=0`` → the first non-empty bucket's
        bound), ``q=1`` to the one holding the largest."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        cum = np.cumsum(self.counts)
        # clamp the target rank into [1, count]: ranks below one
        # observation resolve to the first observation's bucket
        target = min(max(q * self.count, 1.0), float(self.count))
        k = int(np.searchsorted(cum, target, side="left"))
        return self.boundaries[k] if k < len(self.boundaries) \
            else self.observed_max

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold a same-boundary histogram in (the multi-replica
        roll-up: fixed boundaries mean merging never re-bins)."""
        if not isinstance(other, Histogram) \
                or other.boundaries != self.boundaries:
            raise ValueError(
                f"histogram {self.name!r}: can only merge a histogram "
                f"with identical boundaries (got "
                f"{getattr(other, 'boundaries', type(other))})")
        self.counts += other.counts
        self.sum += other.sum
        self.count += other.count
        self.observed_max = max(self.observed_max, other.observed_max)
        return self

    def expose(self) -> list[str]:
        out = []
        cum = 0
        for b, c in zip(self.boundaries, self.counts):
            cum += int(c)
            out.append(f'{self.name}_bucket{{le="{_fmt(b)}"}} {cum}')
        out.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        out.append(f"{self.name}_sum {_fmt(self.sum)}")
        out.append(f"{self.name}_count {self.count}")
        return out


class MetricsRegistry:
    """A named collection of metrics with get-or-create accessors.

    Accessors are idempotent: asking for an existing name returns the
    live metric (so instrumentation sites never coordinate), but asking
    with a *different* kind (or different histogram boundaries) is an
    error — silently merging incompatible series is how dashboards lie.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, kind: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} (want "
                             f"[a-zA-Z_:][a-zA-Z0-9_:]*)")
        m = self._metrics.get(name)
        if m is not None and m.kind != kind:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        m = self._get(name, "counter")
        if m is None:
            m = self._metrics[name] = Counter(name, help)
        return m

    def gauge(self, name: str, help: str = "") -> Gauge:
        m = self._get(name, "gauge")
        if m is None:
            m = self._metrics[name] = Gauge(name, help)
        return m

    def histogram(self, name: str,
                  boundaries: Sequence[float] = LATENCY_BOUNDARIES,
                  help: str = "") -> Histogram:
        m = self._get(name, "histogram")
        if m is None:
            m = self._metrics[name] = Histogram(name, boundaries, help)
        elif m.boundaries != tuple(float(b) for b in boundaries):
            raise ValueError(f"histogram {name!r} already registered "
                             f"with boundaries {m.boundaries}")
        return m

    def quantile(self, name: str, *, max_centroids: int = 128,
                 quantiles: Sequence[float] = (0.5, 0.9, 0.99),
                 help: str = ""):
        """Get-or-create a live :class:`repro_torch.obs.analyze.
        QuantileSketch` (Prometheus ``summary`` kind): a mergeable
        fixed-centroid sketch answering rolling p50/p99 without storing
        samples — what the serving engines expose live sojourn tails
        through."""
        # deferred: the sketch lives in the analyze layer above this one
        from repro_torch.obs.analyze.sketch import QuantileSketch
        m = self._get(name, "summary")
        if m is None:
            m = self._metrics[name] = QuantileSketch(
                name, max_centroids=max_centroids, quantiles=quantiles,
                help=help)
        elif m.max_centroids != int(max_centroids):
            raise ValueError(f"quantile sketch {name!r} already "
                             f"registered with max_centroids="
                             f"{m.max_centroids}")
        return m

    def __len__(self) -> int:
        return len(self._metrics)

    def __iter__(self):
        return iter(self._metrics.values())

    def get(self, name: str):
        return self._metrics.get(name)

    # -- export -----------------------------------------------------------
    def to_prometheus(self) -> str:
        """The Prometheus text exposition format (version 0.0.4): what
        a ``/metrics`` endpoint returns to a scrape."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_rows(self, name: str = "metrics") -> list[dict]:
        """Flat benchmark-style rows (the ``results/`` record schema):
        one row carrying every counter/gauge, plus one row per
        histogram with its bucket counts."""
        scalars = {m.name: m.value for m in self._metrics.values()
                   if m.kind in ("counter", "gauge")}
        rows = [{"name": name, **dict(sorted(scalars.items()))}]
        for hname in sorted(self._metrics):
            m = self._metrics[hname]
            if m.kind == "histogram":
                rows.append({
                    "name": f"{name}_hist_{hname}",
                    "boundaries": list(m.boundaries),
                    "counts": [int(c) for c in m.counts],
                    "sum": m.sum, "count": m.count,
                })
            elif m.kind == "summary":
                rows.append({
                    "name": f"{name}_quantiles_{hname}",
                    "quantiles": {str(q): m.quantile(q)
                                  for q in m.quantiles},
                    "sum": m.sum, "count": m.count,
                })
        return rows

    def save(self, path: str, name: str = "metrics") -> None:
        import json
        import os
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_rows(name), f, indent=1, default=float)
