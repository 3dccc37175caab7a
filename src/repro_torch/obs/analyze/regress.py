"""Regression gating: compare fresh benchmark / telemetry rows against
a committed baseline with per-metric tolerance bands — the port of
``repro.obs.analyze.regress``.

Both sides use the flat ``results/`` record schema the benchmarks and
``MetricsRegistry.to_rows()`` write: ``[{"name": ..., metric: value,
...}, ...]``.  Rows match by ``"name"``; within a matched row every
metric is checked by *direction*:

  * **lower-better** (``*_s``, ``*_ms``, ``us_per_*``, ``*_err``,
    ``nrmse``, ``miss*``, latency-ish names): flag when the fresh value
    exceeds ``base × (1 + tol)``;
  * **higher-better** (``*_per_s`` / ``*_per_sec``, ``speedup*``,
    ``throughput*``, ``*tokens*``): flag when the fresh value falls
    below ``base × (1 − tol)``;
  * **either** (unrecognised numerics — config scalars, counts): flag
    when the relative deviation exceeds ``tol`` in *any* direction;
  * strings / bools: must be equal (a changed backend tag or
    ``interpret`` flag is a config change, not noise).

Good-direction moves are reported as improvements, never failures.
A baseline value of exactly ``0`` makes relative bands meaningless, so
any bad-direction deviation there flags.

``python -m repro_torch.obs.analyze regress BASE [FRESH]`` is the CI gate:
exit 0 clean, 1 on regression, 2 on usage/IO error.  ``--selftest``
proves the gate has teeth without fresh data: the baseline compared to
itself must pass, and a synthetically perturbed copy (each eligible
metric pushed past its band in the bad direction) must be flagged —
so CI can gate on committed wall-time baselines whose absolute numbers
are machine-dependent.
"""
from __future__ import annotations

import copy
import dataclasses
import json
from typing import Optional, Sequence

__all__ = ["MetricCheck", "RegressionReport", "compare_rows",
           "compare_files", "direction_of", "load_rows", "selftest"]

#: default relative tolerance band (wall-time benchmarks are noisy;
#: deterministic virtual-time metrics should override much tighter)
DEFAULT_TOL = 0.2

#: substrings marking higher-is-better metrics (checked FIRST:
#: ``decisions_per_s`` must not fall through to the ``_s`` rule)
_HIGHER = ("per_sec", "per_s", "speedup", "throughput", "tokens")

#: suffix / substring rules for lower-is-better metrics
_LOWER_SUFFIX = ("_s", "_ms", "_us", "_err", "_bytes")
_LOWER_SUB = ("us_per", "ms_per", "nrmse", "miss", "latency", "sojourn",
              "wait", "rel_err", "overhead")

#: metadata keys never compared
_SKIP = ("name",)


def direction_of(metric: str) -> str:
    """``"higher"`` / ``"lower"`` / ``"either"`` for a metric name."""
    m = metric.lower()
    if any(s in m for s in _HIGHER):
        return "higher"
    if m.endswith(_LOWER_SUFFIX) or any(s in m for s in _LOWER_SUB):
        return "lower"
    return "either"


@dataclasses.dataclass
class MetricCheck:
    """Outcome of one (row, metric) comparison."""
    row: str
    metric: str
    direction: str
    base: object
    fresh: object
    rel_delta: float          # (fresh − base) / |base|; 0 for strings
    tol: float
    status: str               # "ok" | "improved" | "regressed"

    def describe(self) -> str:
        if isinstance(self.base, str) or isinstance(self.base, bool):
            return (f"{self.row}.{self.metric}: {self.base!r} -> "
                    f"{self.fresh!r} ({self.status})")
        return (f"{self.row}.{self.metric} [{self.direction}]: "
                f"{self.base:.6g} -> {self.fresh:.6g} "
                f"({self.rel_delta:+.1%}, tol ±{self.tol:.0%}, "
                f"{self.status})")


@dataclasses.dataclass
class RegressionReport:
    """Everything the gate decided, machine- and human-readable."""
    checked: int
    regressions: list[MetricCheck]
    improvements: list[MetricCheck]
    missing_rows: list[str]     # in baseline, absent from fresh
    extra_rows: list[str]       # in fresh, absent from baseline

    @property
    def ok(self) -> bool:
        return not self.regressions and not self.missing_rows

    def to_dict(self) -> dict:
        return {
            "ok": self.ok, "checked": self.checked,
            "regressions": [dataclasses.asdict(c)
                            for c in self.regressions],
            "improvements": [dataclasses.asdict(c)
                             for c in self.improvements],
            "missing_rows": self.missing_rows,
            "extra_rows": self.extra_rows,
        }

    def table_str(self) -> str:
        lines = [f"== regression gate: "
                 f"{'PASS' if self.ok else 'FAIL'} "
                 f"({self.checked} metrics checked, "
                 f"{len(self.regressions)} regressed, "
                 f"{len(self.improvements)} improved) =="]
        for c in self.regressions:
            lines.append(f"  REGRESSED  {c.describe()}")
        for r in self.missing_rows:
            lines.append(f"  MISSING    row {r!r} absent from fresh run")
        for c in self.improvements:
            lines.append(f"  improved   {c.describe()}")
        for r in self.extra_rows:
            lines.append(f"  (new row {r!r} not in baseline)")
        return "\n".join(lines)


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _check(row: str, metric: str, base, fresh, tol: float
           ) -> Optional[MetricCheck]:
    """Compare one metric; None when incomparable (missing / non-scalar
    on either side — new metrics in fresh rows are not regressions)."""
    if fresh is None or base is None:
        return None
    if isinstance(base, (str, bool)) or isinstance(fresh, (str, bool)):
        status = "ok" if base == fresh else "regressed"
        return MetricCheck(row, metric, "equal", base, fresh, 0.0,
                           0.0, status)
    if not (_is_number(base) and _is_number(fresh)):
        return None
    d = direction_of(metric)
    if base == 0:
        # no relative band at zero: any bad-direction move flags
        bad = (fresh > 0 if d == "lower" else
               fresh < 0 if d == "higher" else fresh != 0)
        good = (fresh < 0 if d == "lower" else
                fresh > 0 if d == "higher" else False)
        rel = float("inf") if fresh != 0 else 0.0
        status = "regressed" if bad else ("improved" if good else "ok")
        return MetricCheck(row, metric, d, base, fresh,
                           rel if fresh != 0 else 0.0, tol, status)
    rel = (fresh - base) / abs(base)
    if d == "lower":
        status = ("regressed" if rel > tol else
                  "improved" if rel < -tol else "ok")
    elif d == "higher":
        status = ("regressed" if rel < -tol else
                  "improved" if rel > tol else "ok")
    else:
        status = "regressed" if abs(rel) > tol else "ok"
    return MetricCheck(row, metric, d, float(base), float(fresh),
                       float(rel), tol, status)


def compare_rows(base_rows: Sequence[dict], fresh_rows: Sequence[dict],
                 *, default_tol: float = DEFAULT_TOL,
                 tol: Optional[dict] = None) -> RegressionReport:
    """Gate ``fresh_rows`` against ``base_rows``.

    ``tol`` maps metric names (or ``"row.metric"``, more specific wins)
    to per-metric relative tolerances overriding ``default_tol``.
    Baseline rows absent from the fresh run fail the gate; fresh rows
    absent from the baseline are reported but do not fail (new
    benchmarks land before their baselines do).
    """
    tol = tol or {}
    fresh_by = {r.get("name"): r for r in fresh_rows}
    checked = 0
    regs: list[MetricCheck] = []
    imps: list[MetricCheck] = []
    missing = []
    for row in base_rows:
        rname = row.get("name", "?")
        fresh = fresh_by.get(rname)
        if fresh is None:
            missing.append(rname)
            continue
        for metric, base_v in row.items():
            if metric in _SKIP:
                continue
            t = tol.get(f"{rname}.{metric}", tol.get(metric,
                                                     default_tol))
            c = _check(rname, metric, base_v, fresh.get(metric), t)
            if c is None:
                continue
            checked += 1
            if c.status == "regressed":
                regs.append(c)
            elif c.status == "improved":
                imps.append(c)
    base_names = {r.get("name") for r in base_rows}
    extra = [n for n in fresh_by if n not in base_names]
    return RegressionReport(checked=checked, regressions=regs,
                            improvements=imps, missing_rows=missing,
                            extra_rows=extra)


def load_rows(path: str) -> list[dict]:
    """Load a ``results/`` rows JSON; a bare dict wraps into one row."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = [{"name": data.get("name", "summary"), **data}]
    if not isinstance(data, list) or not all(
            isinstance(r, dict) for r in data):
        raise ValueError(f"{path}: expected a JSON list of row dicts")
    return data


def compare_files(base_path: str, fresh_path: str, *,
                  default_tol: float = DEFAULT_TOL,
                  tol: Optional[dict] = None) -> RegressionReport:
    return compare_rows(load_rows(base_path), load_rows(fresh_path),
                        default_tol=default_tol, tol=tol)


def selftest(base_rows: Sequence[dict], *,
             default_tol: float = DEFAULT_TOL,
             tol: Optional[dict] = None) -> tuple[bool, str]:
    """Prove the gate works on this baseline without fresh data:
    (1) baseline vs itself must pass with zero regressions; (2) a copy
    with every eligible numeric metric perturbed past its band in the
    bad direction must be flagged on every perturbed metric.  Returns
    ``(ok, report_text)``."""
    clean = compare_rows(base_rows, base_rows,
                         default_tol=default_tol, tol=tol)
    lines = ["-- selftest: baseline vs itself --", clean.table_str()]
    ok = clean.ok and not clean.regressions
    if not ok:
        lines.append("selftest FAIL: baseline does not match itself")
        return False, "\n".join(lines)
    tol = tol or {}
    perturbed = copy.deepcopy(list(base_rows))
    expected: set[tuple[str, str]] = set()
    for row in perturbed:
        rname = row.get("name", "?")
        for metric, v in list(row.items()):
            if metric in _SKIP or not _is_number(v) or v == 0:
                continue
            t = tol.get(f"{rname}.{metric}", tol.get(metric,
                                                     default_tol))
            d = direction_of(metric)
            factor = 1.0 + 3.0 * max(t, 1e-9)
            row[metric] = v * factor if d != "higher" else v / factor
            expected.add((rname, metric))
    dirty = compare_rows(base_rows, perturbed,
                         default_tol=default_tol, tol=tol)
    flagged = {(c.row, c.metric) for c in dirty.regressions}
    unflagged = sorted(expected - flagged)
    lines.append(f"-- selftest: perturbed copy — "
                 f"{len(flagged)}/{len(expected)} perturbations "
                 f"flagged --")
    if unflagged:
        ok = False
        for r, m in unflagged:
            lines.append(f"selftest FAIL: perturbed {r}.{m} "
                         f"not flagged")
    else:
        lines.append("selftest PASS")
    return ok, "\n".join(lines)
