"""Differential profiling: what moved between two traced runs — the
port of ``repro.obs.analyze.diff``.

:func:`diff` aligns two runs — by task id (name) or by arrival order —
and reports, per lifecycle phase (``sojourn``, ``queue_wait``,
``service``, ``transfer``):

  * mean / p50 / p90 / p99 deltas (run B − run A, positive = B slower);
  * the two-sample Kolmogorov–Smirnov statistic (max ECDF distance, no
    scipy) as a scale-free distribution-shift score;
  * the top-k *regressed* tasks by sojourn delta, each with its phase
    breakdown — the "which requests got slower and where" view.

This is the comparison seam for ``engine="event"`` vs ``"fleet"``
(identical seeds must diff to all-zero — pinned), ``backend=`` choices,
mean vs tail-aware cost models, and canary predictor versions.
``diff(run, run)`` is identically zero: every delta ``0.0``, every K-S
statistic ``0.0``, no unmatched tasks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.obs.analyze.tables import TaskTable, load

__all__ = ["DiffReport", "PhaseDiff", "diff", "ks_statistic"]

#: the distributions compared, in report order
DIFF_PHASES = ("sojourn", "queue_wait", "service", "transfer")


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov–Smirnov statistic ``sup |F_a − F_b|``
    (statistic only — no p-value, no scipy).  Exactly ``0.0`` for
    identical samples."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    if a.size == 0 or b.size == 0:
        return 0.0 if a.size == b.size else 1.0
    grid = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, grid, side="right") / a.size
    cdf_b = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(cdf_a - cdf_b).max())


@dataclasses.dataclass
class PhaseDiff:
    """Distribution comparison for one phase (B − A deltas)."""
    phase: str
    mean_a: float
    mean_b: float
    mean_delta: float
    p50_delta: float
    p90_delta: float
    p99_delta: float
    ks: float

    @property
    def is_zero(self) -> bool:
        return (self.mean_delta == 0.0 and self.p50_delta == 0.0
                and self.p90_delta == 0.0 and self.p99_delta == 0.0
                and self.ks == 0.0)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DiffReport:
    """Full differential-profiling report for two runs."""
    phases: dict[str, PhaseDiff]
    n_a: int
    n_b: int
    matched: int
    only_a: int
    only_b: int
    align: str
    top_regressions: list[dict]

    @property
    def is_zero(self) -> bool:
        """True iff nothing moved: all phase deltas and K-S statistics
        are exactly zero and every task matched."""
        return (self.only_a == 0 and self.only_b == 0
                and all(p.is_zero for p in self.phases.values())
                and all(r["sojourn_delta_s"] == 0.0
                        for r in self.top_regressions))

    def to_dict(self) -> dict:
        return {
            "align": self.align, "n_a": self.n_a, "n_b": self.n_b,
            "matched": self.matched, "only_a": self.only_a,
            "only_b": self.only_b, "is_zero": self.is_zero,
            "phases": {k: p.to_dict() for k, p in self.phases.items()},
            "top_regressions": self.top_regressions,
        }

    def table_str(self) -> str:
        lines = [f"== diff (B − A, align={self.align}) ==",
                 f"  tasks: {self.matched} matched, {self.only_a} only "
                 f"in A, {self.only_b} only in B"]
        hdr = (f"  {'phase':>12} {'mean_a':>10} {'mean_b':>10} "
               f"{'Δmean':>10} {'Δp50':>10} {'Δp99':>10} {'KS':>6}")
        lines.append(hdr)
        for p in self.phases.values():
            lines.append(
                f"  {p.phase:>12} {p.mean_a:10.4g} {p.mean_b:10.4g} "
                f"{p.mean_delta:+10.3g} {p.p50_delta:+10.3g} "
                f"{p.p99_delta:+10.3g} {p.ks:6.3f}")
        if self.top_regressions:
            lines.append("  -- top regressed tasks (Δsojourn) --")
            for r in self.top_regressions:
                lines.append(
                    f"  {r['task']:>12}: {r['sojourn_delta_s']:+.4g}s "
                    f"(Δwait {r['queue_wait_delta_s']:+.3g}, "
                    f"Δservice {r['service_delta_s']:+.3g}, "
                    f"Δtransfer {r['transfer_delta_s']:+.3g})")
        if self.is_zero:
            lines.append("  (runs are identical)")
        return "\n".join(lines)


def _phase_arrays(t: TaskTable) -> dict[str, np.ndarray]:
    return {"sojourn": t.sojourn_s, "queue_wait": t.queue_wait_s,
            "service": t.service_s, "transfer": t.transfer_s}


def _align(ta: TaskTable, tb: TaskTable, align: str
           ) -> tuple[np.ndarray, np.ndarray]:
    """Matched row-index pairs ``(idx_a, idx_b)``."""
    if align == "task":
        # task names are the ids; duplicate names pair off in order
        slots: dict[str, list[int]] = {}
        for j, name in enumerate(tb.task):
            slots.setdefault(name, []).append(j)
        ia, ib = [], []
        for i, name in enumerate(ta.task):
            if slots.get(name):
                ia.append(i)
                ib.append(slots[name].pop(0))
        return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
    if align == "arrival":
        # pair the k-th arrival of A with the k-th arrival of B
        n = min(len(ta), len(tb))
        oa = np.argsort(ta.arrived_s, kind="stable")[:n]
        ob = np.argsort(tb.arrived_s, kind="stable")[:n]
        return oa, ob
    raise ValueError(f"unknown align {align!r}; use 'task' or 'arrival'")


def diff(a, b, *, align: str = "task", top_k: int = 10) -> DiffReport:
    """Differential profile of run ``b`` against baseline ``a``.

    ``a`` / ``b`` accept anything :func:`repro_torch.obs.analyze.load` does
    (Tracer, Telemetry, trace.json path/dict, TraceTable).
    Distribution statistics (deltas at the quantiles, K-S) compare the
    *full* per-run distributions; the top-k regression list uses the
    aligned pairs (``align="task"`` by task name, ``"arrival"`` by
    arrival order).
    """
    ta, tb = load(a).lifecycles(), load(b).lifecycles()
    pa, pb = _phase_arrays(ta), _phase_arrays(tb)
    phases = {}
    for ph in DIFF_PHASES:
        xa, xb = pa[ph], pb[ph]
        ea = float(xa.mean()) if xa.size else 0.0
        eb = float(xb.mean()) if xb.size else 0.0
        qa = np.percentile(xa, [50, 90, 99]) if xa.size \
            else np.zeros(3)
        qb = np.percentile(xb, [50, 90, 99]) if xb.size \
            else np.zeros(3)
        phases[ph] = PhaseDiff(
            phase=ph, mean_a=ea, mean_b=eb, mean_delta=eb - ea,
            p50_delta=float(qb[0] - qa[0]),
            p90_delta=float(qb[1] - qa[1]),
            p99_delta=float(qb[2] - qa[2]),
            ks=ks_statistic(xa, xb))
    ia, ib = _align(ta, tb, align)
    deltas = tb.sojourn_s[ib] - ta.sojourn_s[ia] if ia.size \
        else np.empty(0)
    order = np.argsort(-deltas, kind="stable")[:max(int(top_k), 0)]
    top = [{
        "task": ta.task[int(ia[k])],
        "sojourn_a_s": float(ta.sojourn_s[ia[k]]),
        "sojourn_b_s": float(tb.sojourn_s[ib[k]]),
        "sojourn_delta_s": float(deltas[k]),
        "queue_wait_delta_s": float(tb.queue_wait_s[ib[k]]
                                    - ta.queue_wait_s[ia[k]]),
        "service_delta_s": float(tb.service_s[ib[k]]
                                 - ta.service_s[ia[k]]),
        "transfer_delta_s": float(tb.transfer_s[ib[k]]
                                  - ta.transfer_s[ia[k]]),
        "track_a": ta.track[int(ia[k])], "track_b": tb.track[int(ib[k])],
    } for k in order]
    return DiffReport(
        phases=phases, n_a=len(ta), n_b=len(tb), matched=int(ia.size),
        only_a=len(ta) - int(ia.size), only_b=len(tb) - int(ib.size),
        align=align, top_regressions=top)
