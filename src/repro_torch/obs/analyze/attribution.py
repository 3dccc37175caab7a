"""Phase attribution: where did each task's sojourn go, and why were
deadlines missed — the port of ``repro.obs.analyze.attribution``.

:func:`attribute` ingests any trace source (``Tracer`` / ``trace.json``
/ ``Telemetry``) and answers the question monitoring alone cannot:
**decomposition** — ``sojourn = queue_wait + service + transfer +
residual`` per task and aggregated per run (the per-run aggregates
reproduce ``Telemetry.summary()`` exactly from spans alone, pinned in
``tests/test_torch_obs_analyze.py``); **critical path** — the gap-free
segment chain covering each task's lifecycle with its dominant phase;
and **miss attribution** — each deadline miss classified by dominant
cause, cross-referenced against the control-plane instants
(``pool_saturation`` / ``link_drift`` / ``ph_drift``) the engines
emitted in the same window.

The miss-cause taxonomy (deterministic; the reference's, documented in
its ``docs/observability.md``):

``pool_contention``
    queue wait is the phase most inflated over its run median —
    corroborated when a ``pool_saturation`` or ``pool_wait`` instant
    fell inside the task's ``[arrived, finished]`` window.
``link_drift``
    transfer is the most inflated phase *and* a ``link_drift`` instant
    fell inside the window: bandwidth moved under the task.
``rtt_tail``
    transfer is the most inflated phase with no drift instant in the
    window — a heavy-tailed RTT draw, not a channel change
    (corroborated when the transfer exceeds the run's p90 transfer).
``service_underprediction``
    service is the most inflated phase: the placement-time ETC was
    wrong — corroborated when a ``ph_drift`` (Page–Hinkley) instant
    fell inside the window, i.e. the oracle saw it too.

Ties break toward ``queue_wait`` then ``transfer`` then ``service`` —
contention and the network are actionable (add capacity, re-pick the
split); underprediction is the residual explanation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.obs.analyze.tables import TaskTable, TraceTable, load

__all__ = ["RunAttribution", "attribute", "MISS_CAUSES"]

#: classifier output classes, in tie-break priority order
MISS_CAUSES = ("pool_contention", "link_drift", "rtt_tail",
               "service_underprediction")

#: phase columns the classifier ranks, mapped to their cause families
_PHASE_ORDER = ("queue_wait", "transfer", "service")


@dataclasses.dataclass
class RunAttribution:
    """Attribution results for one run: the lifecycle table plus the
    trace it came from (instants feed the miss classifier)."""

    table: TraceTable
    tasks: TaskTable

    # -- per-run ----------------------------------------------------------
    def summary(self) -> dict:
        """Run-level aggregates recomputed *from spans alone* — the
        keys shared with ``Telemetry.summary()`` (``p50/p99/
        mean_completion_s``, ``p90_completion_s``, ``p99/mean_wait_s``,
        ``n_tasks``, ``deadline_misses``, ``miss_rate``) are float-exact
        equal to it on a traced run, because the spans carry the same
        values in the same completion order."""
        t = self.tasks
        soj, waits = t.sojourn_s, t.queue_wait_s
        n = len(t)
        misses = int(t.missed.sum())
        out = {
            "n_tasks": n,
            "p50_completion_s": float(np.percentile(soj, 50)) if n else 0.0,
            "p90_completion_s": float(np.percentile(soj, 90)) if n else 0.0,
            "p99_completion_s": float(np.percentile(soj, 99)) if n else 0.0,
            "mean_completion_s": float(soj.mean()) if n else 0.0,
            "p99_wait_s": float(np.percentile(waits, 99)) if n else 0.0,
            "mean_wait_s": float(waits.mean()) if n else 0.0,
            "deadline_misses": misses,
            "miss_rate": misses / n if n else 0.0,
        }
        out.update({f"total_{k}_s": v for k, v in
                    self.phase_totals().items()})
        return out

    def phase_totals(self) -> dict[str, float]:
        """Total seconds per phase across the run — the pie chart of
        where sojourn went.  Keys: ``queue_wait``, ``service``,
        ``transfer``, ``residual``, ``sojourn``."""
        t = self.tasks
        return {
            "queue_wait": float(t.queue_wait_s.sum()),
            "service": float(t.service_s.sum()),
            "transfer": float(t.transfer_s.sum()),
            "residual": float(t.residual_s.sum()),
            "sojourn": float(t.sojourn_s.sum()),
        }

    def phase_shares(self) -> dict[str, float]:
        """Phase totals as fractions of total sojourn."""
        totals = self.phase_totals()
        denom = totals["sojourn"] or 1.0
        return {k: v / denom for k, v in totals.items()
                if k != "sojourn"}

    def by_track(self) -> dict[str, dict[str, float]]:
        """Phase totals per track (per node/pool): which node the
        queueing actually accrued on."""
        t = self.tasks
        out: dict[str, dict[str, float]] = {}
        for i, track in enumerate(t.track):
            d = out.setdefault(track, {"queue_wait": 0.0, "service": 0.0,
                                       "transfer": 0.0, "n_tasks": 0})
            d["queue_wait"] += float(t.queue_wait_s[i])
            d["service"] += float(t.service_s[i])
            d["transfer"] += float(t.transfer_s[i])
            d["n_tasks"] += 1
        return out

    # -- per-task ---------------------------------------------------------
    def critical_path(self, i: int) -> list[tuple[str, float, float]]:
        """Task ``i``'s lifecycle as the ordered gap-free segment chain
        ``(phase, duration_s, fraction_of_sojourn)`` — queue_wait,
        service, transfer (zero-length phases omitted), with any float
        residue folded into a trailing ``residual`` segment.  The
        chain IS the critical path of a single-task lifecycle: every
        segment delays completion one-for-one."""
        t = self.tasks
        soj = float(t.sojourn_s[i]) or 1.0
        segs = [("queue_wait", float(t.queue_wait_s[i])),
                ("service", float(t.service_s[i])),
                ("transfer", float(t.transfer_s[i]))]
        out = [(name, d, d / soj) for name, d in segs if d > 0.0]
        res = float(t.residual_s[i])
        if abs(res) > 1e-12 * max(soj, 1.0):
            out.append(("residual", res, res / soj))
        return out

    def dominant_phase(self, i: int) -> str:
        """The phase that ate most of task ``i``'s sojourn."""
        path = self.critical_path(i)
        return max(path, key=lambda seg: seg[1])[0] if path else "service"

    def per_task(self) -> list[dict]:
        """One plain-dict breakdown per task (reports / JSON export)."""
        t = self.tasks
        return [{
            "task": t.task[i], "track": t.track[i], "tid": int(t.tid[i]),
            "arrived_s": float(t.arrived_s[i]),
            "finished_s": float(t.finished_s[i]),
            "sojourn_s": float(t.sojourn_s[i]),
            "queue_wait_s": float(t.queue_wait_s[i]),
            "service_s": float(t.service_s[i]),
            "transfer_s": float(t.transfer_s[i]),
            "dominant_phase": self.dominant_phase(i),
            "missed": bool(t.missed[i]),
        } for i in range(len(t))]

    # -- miss attribution -------------------------------------------------
    def miss_attribution(self) -> dict:
        """Classify every deadline miss by dominant cause (taxonomy in
        the module docstring).  Returns ``{"n_tasks", "n_misses",
        "miss_rate", "by_cause": {cause: count}, "misses": [...]}``
        with one record per miss carrying the cause, the corroborating
        instant evidence, and the phase breakdown."""
        t = self.tasks
        n = len(t)
        missed = np.flatnonzero(t.missed)
        med = {
            "queue_wait": float(np.median(t.queue_wait_s)) if n else 0.0,
            "service": float(np.median(t.service_s)) if n else 0.0,
            "transfer": float(np.median(t.transfer_s)) if n else 0.0,
        }
        p90_transfer = float(np.percentile(t.transfer_s, 90)) if n else 0.0
        phase_cols = {"queue_wait": t.queue_wait_s,
                      "service": t.service_s, "transfer": t.transfer_s}
        by_cause = {c: 0 for c in MISS_CAUSES}
        misses = []
        for i in missed:
            i = int(i)
            window = (float(t.arrived_s[i]), float(t.finished_s[i]))
            names_in = {self.table.inst_name[k] for k in
                        self.table.instants_in(*window)}
            # inflation of each phase over its run-wide median; ties
            # resolve in _PHASE_ORDER priority (max is stable on order)
            inflation = {p: float(phase_cols[p][i]) - med[p]
                         for p in _PHASE_ORDER}
            dominant = max(_PHASE_ORDER, key=lambda p: inflation[p])
            if dominant == "queue_wait":
                cause = "pool_contention"
                evidence = sorted(names_in
                                  & {"pool_saturation", "pool_wait"})
            elif dominant == "transfer":
                if "link_drift" in names_in:
                    cause = "link_drift"
                    evidence = ["link_drift"]
                else:
                    cause = "rtt_tail"
                    evidence = (["transfer>p90"] if
                                float(t.transfer_s[i]) > p90_transfer
                                else [])
            else:
                cause = "service_underprediction"
                evidence = sorted(names_in & {"ph_drift", "oracle_refit"})
            by_cause[cause] += 1
            misses.append({
                "task": t.task[i], "track": t.track[i],
                "tid": int(t.tid[i]),
                "deadline_s": float(t.deadline_s[i]),
                "finished_s": float(t.finished_s[i]),
                "excess_s": float(t.finished_s[i] - t.deadline_s[i]),
                "cause": cause,
                "dominant_phase": dominant,
                "corroborated": bool(evidence),
                "evidence": evidence,
                "phases": {p: float(phase_cols[p][i])
                           for p in _PHASE_ORDER},
            })
        return {"n_tasks": n, "n_misses": len(misses),
                "miss_rate": len(misses) / n if n else 0.0,
                "by_cause": by_cause, "misses": misses}

    # -- report -----------------------------------------------------------
    def table_str(self) -> str:
        """Human-readable attribution report (CLI / examples)."""
        s = self.summary()
        shares = self.phase_shares()
        lines = ["== run attribution =="]
        lines += [f"  {k:>20}: {v:.6g}" if isinstance(v, float)
                  else f"  {k:>20}: {v}" for k, v in s.items()]
        lines.append("  -- sojourn breakdown (share of total) --")
        lines += [f"  {k:>20}: {100 * v:6.2f}%"
                  for k, v in shares.items()]
        ma = self.miss_attribution()
        if ma["n_misses"]:
            lines.append("  -- deadline-miss attribution --")
            for cause, cnt in ma["by_cause"].items():
                if cnt:
                    lines.append(f"  {cause:>24}: {cnt}")
        return "\n".join(lines)


def attribute(source) -> RunAttribution:
    """Attribution entry point: accepts a ``Tracer``, a ``Telemetry``,
    a ``trace.json`` path / dict / event list, or a prebuilt
    :class:`TraceTable`."""
    table = load(source)
    return RunAttribution(table=table, tasks=table.lifecycles())
