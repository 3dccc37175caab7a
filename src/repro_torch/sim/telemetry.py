"""Per-run streaming telemetry: completion percentiles, deadline misses,
energy, node utilisation, and re-plan counters — the port of
``repro.sim.telemetry``.

Every simulator run fills one :class:`Telemetry`: schedulers count their
incremental work (``replans``, ``column_refreshes``, ...), and each
finished task contributes a :class:`TaskRecord`.  ``summary()`` reduces
that to the run-level numbers the paper's evaluation reports (p50/p99
completion, misses, joules, utilisation), and ``to_rows()`` / ``save()``
export the same flat ``[{"name": ..., metric: ...}]`` record schema the
``results/`` benchmark JSONs use.  Host numpy code, the reference's
reductions in its order.

The ``repro.obs`` exports (``registry``, ``to_prometheus``,
``attribution``) wait for the port of ``obs`` (ROADMAP.md §1 item 11) and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import Counter
from typing import Optional

import numpy as np

_OBS_PENDING = ("Telemetry.{} needs the port of repro.obs, which is not "
                "done yet (ROADMAP.md §1 item 11)")


@dataclasses.dataclass
class TaskRecord:
    """One completed task's life cycle in virtual time (seconds)."""
    name: str
    arrived_s: float
    started_s: float
    finished_s: float
    node: str = ""
    # distinguishes same-spec nodes (clusters routinely repeat device
    # specs, so the spec name alone is not a node identity)
    node_id: Optional[int] = None
    deadline_s: Optional[float] = None
    energy_j: float = 0.0
    split: Optional[int] = None      # final offload split, if planned
    switches: int = 0                # Pareto re-picks that changed it
    transfer_s: float = 0.0          # network delay (sampled RTT)

    @property
    def sojourn_s(self) -> float:
        """Arrival → completion (queueing + service + transfer)."""
        return self.finished_s - self.arrived_s

    @property
    def wait_s(self) -> float:
        """Queueing delay: arrival → start of service."""
        return self.started_s - self.arrived_s

    @property
    def service_s(self) -> float:
        """Time in service (start → finish, net of network delay)."""
        return self.finished_s - self.started_s - self.transfer_s

    @property
    def missed(self) -> bool:
        return (self.deadline_s is not None
                and self.finished_s > self.deadline_s)


class Telemetry:
    """Accumulates task records and scheduler counters for one run.

    Records arrive one at a time through :meth:`complete`, the event
    loop's path (the reference's column-batch ``complete_arrays`` serves
    its fleet engine and comes with it, ROADMAP.md §1 item 6).
    """

    def __init__(self):
        self.records: list[TaskRecord] = []
        self.counters: Counter = Counter()
        self.gauges: dict[str, float] = {}

    # -- ingestion --------------------------------------------------------
    def count(self, key: str, n: int = 1) -> None:
        self.counters[key] += n

    def gauge(self, key: str, value: float) -> None:
        """Record the latest value of a float metric (e.g. the oracle's
        rolling nRMSE) — last write wins, exported with the summary."""
        self.gauges[key] = float(value)

    def complete(self, record: TaskRecord) -> None:
        self.records.append(record)

    # -- reductions -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.records)

    @property
    def deadline_misses(self) -> int:
        return sum(1 for r in self.records if r.missed)

    @property
    def makespan_s(self) -> float:
        return max((r.finished_s for r in self.records), default=0.0)

    @property
    def energy_j(self) -> float:
        return float(sum(r.energy_j for r in self.records))

    @staticmethod
    def _cvar_of(soj: np.ndarray, alpha: float) -> float:
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        if soj.size == 0:
            return 0.0
        var = np.percentile(soj, 100.0 * alpha)
        tail = soj[soj >= var]
        return float(tail.mean()) if tail.size else float(var)

    def cvar(self, alpha: float = 0.95) -> float:
        """CVaR_alpha of task sojourn times: the mean sojourn over the
        worst ``(1 - alpha)`` fraction of tasks — the tail statistic
        the tail-aware cost objective optimises for."""
        soj = np.asarray([r.sojourn_s for r in self.records], np.float64)
        return self._cvar_of(soj, alpha)

    def _node_stats(self) -> tuple[dict[str, float], dict[str, float]]:
        """One walk over the records producing both per-node reductions:
        ``(utilisation, mean queue length)`` — busy time and accrued
        queueing delay per node, each divided by the run's makespan.

        Nodes are identified by ``(node_id, node)`` so same-spec nodes
        do not merge; duplicates are labelled ``name@id``."""
        span = self.makespan_s
        busy: Counter = Counter()
        waits: Counter = Counter()
        for r in self.records:
            if r.node:
                busy[(r.node_id, r.node)] += r.finished_s - r.started_s
                waits[(r.node_id, r.node)] += r.wait_s
        names = Counter(name for _, name in busy)
        util: dict[str, float] = {}
        qlen: dict[str, float] = {}
        for nid, name in sorted(busy, key=lambda k: (str(k[1]),
                                                     -1 if k[0] is None
                                                     else k[0])):
            label = name if names[name] == 1 or nid is None \
                else f"{name}@{nid}"
            util[label] = busy[(nid, name)] / span if span > 0 else 0.0
            qlen[label] = waits[(nid, name)] / span if span > 0 else 0.0
        return util, qlen

    def queue_lens(self) -> dict[str, float]:
        """Per-node time-averaged queue length over the makespan
        (Little's law: total queueing delay accrued on the node divided
        by the run's span).  Node labels match :meth:`utilisation`."""
        return self._node_stats()[1]

    def utilisation(self) -> dict[str, float]:
        """Busy fraction per node over the run's makespan (labels as in
        :meth:`_node_stats`)."""
        return self._node_stats()[0]

    def summary(self, *, _util: Optional[dict] = None) -> dict:
        """Run-level metrics (the numbers a paper table would report).

        ``_util`` lets :meth:`to_rows` pass a precomputed utilisation
        dict so the records are walked once, not once per reduction."""
        soj = np.asarray([r.sojourn_s for r in self.records], np.float64)
        waits = np.asarray([r.wait_s for r in self.records], np.float64)
        util = self.utilisation() if _util is None else _util
        span = self.makespan_s
        out = {
            "n_tasks": len(self.records),
            "p50_completion_s": float(np.percentile(soj, 50))
            if soj.size else 0.0,
            "p90_completion_s": float(np.percentile(soj, 90))
            if soj.size else 0.0,
            "p99_completion_s": float(np.percentile(soj, 99))
            if soj.size else 0.0,
            # the tail statistic the tail-aware cost objective optimises
            "cvar95_completion_s": self._cvar_of(soj, 0.95),
            "mean_completion_s": float(soj.mean()) if soj.size else 0.0,
            "makespan_s": self.makespan_s,
            "deadline_misses": self.deadline_misses,
            "miss_rate": self.deadline_misses / len(self.records)
            if self.records else 0.0,
            "energy_j": self.energy_j,
            "mean_utilisation": float(np.mean(list(util.values())))
            if util else 0.0,
            "split_switches": int(sum(r.switches for r in self.records)),
            # queueing breakdown (all 0.0 without finite-capacity pools)
            "p99_wait_s": float(np.percentile(waits, 99))
            if waits.size else 0.0,
            "mean_wait_s": float(waits.mean()) if waits.size else 0.0,
            # fleet-wide time-averaged queue length (Little's law)
            "mean_queue_len": float(waits.sum()) / span
            if span > 0 else 0.0,
        }
        # counters and gauges ride along under their own names;
        # record-derived metrics win on collision (e.g.
        # "split_switches": the records count completed tasks, the
        # planner's counter also includes still-live ones on a
        # truncated run)
        out.update({k: int(v) for k, v in sorted(self.counters.items())
                    if k not in out})
        out.update({k: float(v) for k, v in sorted(self.gauges.items())
                    if k not in out})
        return out

    # -- export (the results/ record schema) ------------------------------
    def to_rows(self, name: str = "sim_stream") -> list[dict]:
        """Flat benchmark-style rows: one summary row plus one row per
        node's utilisation — the same ``[{"name": ..., ...}]`` shape as
        the ``results/bench_*.json`` files.  Both per-node reductions
        come from one record walk (:meth:`_node_stats`), reused by the
        summary row."""
        util, qlen = self._node_stats()
        rows = [{"name": name, **self.summary(_util=util)}]
        rows += [{"name": f"{name}_util_{node}", "utilisation": u,
                  "mean_queue_len": qlen.get(node, 0.0)}
                 for node, u in util.items()]
        return rows

    # -- export (the repro.obs metrics surface) ---------------------------
    def registry(self, prefix: str = "sim"):
        """The reference lifts a run into a ``repro.obs.MetricsRegistry``;
        the port has no ``obs`` metrics yet."""
        raise NotImplementedError(_OBS_PENDING.format("registry"))

    def to_prometheus(self, prefix: str = "sim") -> str:
        raise NotImplementedError(_OBS_PENDING.format("to_prometheus"))

    def attribution(self):
        raise NotImplementedError(_OBS_PENDING.format("attribution"))

    def save(self, path: str, name: str = "sim_stream") -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_rows(name), f, indent=1, default=float)

    def table(self) -> str:
        """Human-readable summary table (used by the examples)."""
        s = self.summary()
        lines = [f"  {k:>20}: {v:.4g}" if isinstance(v, float)
                 else f"  {k:>20}: {v}" for k, v in s.items()]
        return "\n".join(lines)
