"""Columnar trace tables: the analysis-side view of a traced run — the
port of ``repro.obs.analyze.tables``.

:class:`TraceTable` ingests a :class:`repro_torch.obs.Tracer`, a validated
``trace.json`` (Chrome trace-event JSON, the format
:func:`repro_torch.obs.export_chrome` writes), or a finished
:class:`repro_torch.sim.telemetry.Telemetry` into parallel numpy columns —
one row per span and one per instant, in ingestion order.  Everything
downstream (attribution, diff, the miss classifier) reads these columns
instead of walking event objects.

:meth:`TraceTable.lifecycles` reconstructs the per-task lifecycle table
(:class:`TaskTable`): for every ``sojourn`` span it collects the nested
``queue_wait`` / ``service`` / ``transfer`` children on the same
``(track, tid)`` row and emits one columnar task row with the phase
durations, the residual (``sojourn − wait − service − transfer``,
~1e-15 by construction), and the ``deadline_s`` / ``split`` args the
engines stamp on the sojourn span.  Rows keep the sojourn spans'
ingestion order — the same completion order ``Telemetry`` records — so
aggregates computed from spans alone reproduce
``Telemetry.summary()`` exactly (pinned in
``tests/test_torch_obs_analyze.py``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Union

import numpy as np

__all__ = ["TraceTable", "TaskTable", "load"]

#: the lifecycle phase names task_spans emits, in timeline order
PHASES = ("queue_wait", "service", "transfer")


@dataclasses.dataclass
class TaskTable:
    """One row per completed task lifecycle, columnar (see module
    docstring).  ``deadline_s`` is NaN and ``split`` is −1 where the
    trace carried none."""
    task: list[str]
    track: list[str]
    tid: np.ndarray
    arrived_s: np.ndarray
    started_s: np.ndarray
    finished_s: np.ndarray
    sojourn_s: np.ndarray
    queue_wait_s: np.ndarray
    service_s: np.ndarray
    transfer_s: np.ndarray
    residual_s: np.ndarray
    deadline_s: np.ndarray
    split: np.ndarray

    def __len__(self) -> int:
        return len(self.task)

    @property
    def missed(self) -> np.ndarray:
        """Boolean mask of deadline misses (False where no deadline)."""
        with np.errstate(invalid="ignore"):
            return np.where(np.isnan(self.deadline_s), False,
                            self.finished_s > self.deadline_s)

    def phase_matrix(self) -> np.ndarray:
        """``[n, 4]`` columns ``(queue_wait, service, transfer,
        residual)`` — rows sum to ``sojourn_s`` within float residue."""
        return np.stack([self.queue_wait_s, self.service_s,
                         self.transfer_s, self.residual_s], axis=1)


class TraceTable:
    """Columnar spans + instants for one traced run."""

    def __init__(self, *, span_track, span_tid, span_name, span_t0,
                 span_t1, span_args, inst_track, inst_tid, inst_name,
                 inst_ts, inst_args):
        self.span_track: list[str] = span_track
        self.span_tid = np.asarray(span_tid, np.int64)
        self.span_name: list[str] = span_name
        self.span_t0 = np.asarray(span_t0, np.float64)
        self.span_t1 = np.asarray(span_t1, np.float64)
        self.span_args: list[Optional[dict]] = span_args
        self.inst_track: list[str] = inst_track
        self.inst_tid = np.asarray(inst_tid, np.int64)
        self.inst_name: list[str] = inst_name
        self.inst_ts = np.asarray(inst_ts, np.float64)
        self.inst_args: list[Optional[dict]] = inst_args
        self._lifecycles: Optional[TaskTable] = None

    @property
    def n_spans(self) -> int:
        return len(self.span_name)

    @property
    def n_instants(self) -> int:
        return len(self.inst_name)

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_tracer(cls, tracer) -> "TraceTable":
        """Ingest a live :class:`repro_torch.obs.Tracer` (exact float
        endpoints — the path the equivalence pins use)."""
        spans = tracer.all_spans()
        instants = tracer.all_instants()
        return cls(
            span_track=[s.track for s in spans],
            span_tid=[s.tid for s in spans],
            span_name=[s.name for s in spans],
            span_t0=[s.t0 for s in spans],
            span_t1=[s.t1 for s in spans],
            span_args=[s.args for s in spans],
            inst_track=[i.track for i in instants],
            inst_tid=[i.tid for i in instants],
            inst_name=[i.name for i in instants],
            inst_ts=[i.ts for i in instants],
            inst_args=[i.args for i in instants])

    @classmethod
    def from_chrome(cls, trace: Union[str, dict, list]) -> "TraceTable":
        """Ingest an exported ``trace.json`` (path, trace dict, or
        traceEvents list).  The file is validated first
        (:func:`repro_torch.obs.validate_chrome`) so malformed traces fail
        loudly, then B/E pairs re-pair LIFO per ``(pid, tid)``.
        Timestamps come back from the format's microseconds, so
        endpoints round-trip to ~1e-10 s — use :meth:`from_tracer` when
        exactness matters."""
        from repro_torch.obs.chrome import validate_chrome
        validate_chrome(trace)
        if isinstance(trace, str):
            with open(trace) as f:
                trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        track_of: dict[int, str] = {}
        for ev in events:
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                track_of[ev.get("pid", 0)] = ev["args"]["name"]
        s_track, s_tid, s_name, s_t0, s_t1, s_args = \
            [], [], [], [], [], []
        i_track, i_tid, i_name, i_ts, i_args = [], [], [], [], []
        stacks: dict[tuple, list] = {}
        for ev in events:
            ph = ev.get("ph")
            pid, tid = ev.get("pid", 0), ev.get("tid", 0)
            track = track_of.get(pid, str(pid))
            if ph == "B":
                stacks.setdefault((pid, tid), []).append(
                    (ev.get("name"), float(ev["ts"]) / 1e6,
                     ev.get("args")))
            elif ph == "E":
                name, t0, args = stacks[(pid, tid)].pop()
                s_track.append(track)
                s_tid.append(tid)
                s_name.append(name)
                s_t0.append(t0)
                s_t1.append(float(ev["ts"]) / 1e6)
                s_args.append(args)
            elif ph == "i":
                i_track.append(track)
                i_tid.append(tid)
                i_name.append(ev.get("name"))
                i_ts.append(float(ev["ts"]) / 1e6)
                i_args.append(ev.get("args"))
        return cls(span_track=s_track, span_tid=s_tid, span_name=s_name,
                   span_t0=s_t0, span_t1=s_t1, span_args=s_args,
                   inst_track=i_track, inst_tid=i_tid, inst_name=i_name,
                   inst_ts=i_ts, inst_args=i_args)

    @classmethod
    def from_telemetry(cls, telemetry) -> "TraceTable":
        """The rows → analyze bridge: build the lifecycle spans a
        tracer would have recorded from a finished
        :class:`~repro_torch.sim.telemetry.Telemetry`'s task records — so
        attribution and diff work on runs that carried no tracer (no
        instants, so miss causes lose their corroboration column).
        Service ends at ``max(started, finished - transfer)``, as
        :meth:`repro_torch.obs.Tracer.task_spans` ends it (the reference
        builds a negative span there)."""
        s_track, s_tid, s_name, s_t0, s_t1, s_args = \
            [], [], [], [], [], []
        for rid, r in enumerate(telemetry.records):
            track = f"{r.node}@{r.node_id}" if r.node else "run"
            args = {"task": r.name}
            if r.split is not None:
                args["split"] = r.split
            if r.deadline_s is not None:
                args["deadline_s"] = r.deadline_s
            rows = [("sojourn", r.arrived_s, r.finished_s, args)]
            if r.started_s > r.arrived_s:
                rows.append(("queue_wait", r.arrived_s, r.started_s,
                             None))
            # Tracer.task_spans' end of service: a zero service time can
            # round finished - transfer an ulp below started
            service_end = max(r.started_s, r.finished_s - r.transfer_s)
            rows.append(("service", r.started_s, service_end, None))
            if r.transfer_s > 0.0:
                rows.append(("transfer", service_end, r.finished_s,
                             None))
            for name, t0, t1, a in rows:
                s_track.append(track)
                s_tid.append(rid)
                s_name.append(name)
                s_t0.append(t0)
                s_t1.append(t1)
                s_args.append(a)
        return cls(span_track=s_track, span_tid=s_tid, span_name=s_name,
                   span_t0=s_t0, span_t1=s_t1, span_args=s_args,
                   inst_track=[], inst_tid=[], inst_name=[], inst_ts=[],
                   inst_args=[])

    # -- the lifecycle table ----------------------------------------------
    def lifecycles(self) -> TaskTable:
        """The per-task lifecycle table (cached).  One row per
        ``sojourn`` span in ingestion order; ``queue_wait`` / ``service``
        / ``transfer`` children are matched by containment on the same
        ``(track, tid)`` row.  Spans that are not part of a task
        lifecycle (serving ``prefill``/``decode``, custom spans) are
        ignored."""
        if self._lifecycles is not None:
            return self._lifecycles
        children: dict[tuple, list[int]] = {}
        sojourns: list[int] = []
        for k, name in enumerate(self.span_name):
            key = (self.span_track[k], int(self.span_tid[k]))
            if name == "sojourn":
                sojourns.append(k)
            elif name in PHASES:
                children.setdefault(key, []).append(k)
        n = len(sojourns)
        task, track = [], []
        tid = np.zeros(n, np.int64)
        arrived = np.zeros(n)
        started = np.zeros(n)
        finished = np.zeros(n)
        wait = np.zeros(n)
        service = np.zeros(n)
        transfer = np.zeros(n)
        deadline = np.full(n, np.nan)
        split = np.full(n, -1, np.int64)
        for i, k in enumerate(sojourns):
            key = (self.span_track[k], int(self.span_tid[k]))
            t0, t1 = self.span_t0[k], self.span_t1[k]
            args = self.span_args[k] or {}
            task.append(str(args.get("task", f"tid{key[1]}")))
            track.append(key[0])
            tid[i] = key[1]
            arrived[i] = t0
            finished[i] = t1
            started[i] = t0                       # no queue_wait → 0
            if args.get("deadline_s") is not None:
                deadline[i] = float(args["deadline_s"])
            if args.get("split") is not None:
                split[i] = int(args["split"])
            for c in children.get(key, ()):
                if not (t0 <= self.span_t0[c]
                        and self.span_t1[c] <= t1):
                    continue
                dur = self.span_t1[c] - self.span_t0[c]
                name = self.span_name[c]
                if name == "queue_wait":
                    # duration is started − arrived, the exact float
                    # Telemetry's wait_s computes
                    wait[i] = dur
                elif name == "service":
                    service[i] = dur
                    started[i] = self.span_t0[c]
                else:
                    transfer[i] = dur
        sojourn = finished - arrived
        self._lifecycles = TaskTable(
            task=task, track=track, tid=tid, arrived_s=arrived,
            started_s=started, finished_s=finished, sojourn_s=sojourn,
            queue_wait_s=wait, service_s=service, transfer_s=transfer,
            residual_s=sojourn - wait - service - transfer,
            deadline_s=deadline, split=split)
        return self._lifecycles

    def instants_in(self, t0: float, t1: float,
                    names: Optional[tuple] = None) -> list[int]:
        """Indices of instants with ``t0 <= ts <= t1`` (optionally
        restricted to ``names``) — the cross-referencing window the
        miss classifier uses."""
        idx = np.flatnonzero((self.inst_ts >= t0) & (self.inst_ts <= t1))
        if names is not None:
            idx = [int(k) for k in idx if self.inst_name[k] in names]
        return [int(k) for k in idx]


def load(source) -> TraceTable:
    """Polymorphic entry point: a :class:`TraceTable` passes through; a
    :class:`repro_torch.obs.Tracer` ingests exactly; a ``Telemetry`` takes
    the rows bridge; a path / trace dict / traceEvents list parses as
    Chrome trace JSON (validated first)."""
    if isinstance(source, TraceTable):
        return source
    if hasattr(source, "all_spans"):             # a Tracer
        return TraceTable.from_tracer(source)
    if hasattr(source, "records"):               # a Telemetry
        return TraceTable.from_telemetry(source)
    return TraceTable.from_chrome(source)
