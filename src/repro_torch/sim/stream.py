"""Online streaming placement: incremental min-min / HEFT over a live
``[T, N]`` finish matrix, plus the event-driven run loop — the port of
``repro.sim.stream``.

The batch schedulers in :mod:`repro_torch.core.scheduler` assume every
task is known at t=0 and place all of them in one pass.
:class:`StreamScheduler` is their online twin: tasks arrive over virtual
time, each admission event extends the finish matrix by the arriving rows
only, each placement refreshes the placed node's column only, and each
link-state update refreshes the affected node's ETC column only — the
matrix is *never* rebuilt from scratch (``full_rebuilds`` stays 0).

Equivalence pin (tested): with every arrival at t=0 and static links,
``StreamScheduler.run`` reproduces the batch ``min_min`` / ``heft``
schedules bit-for-bit — same arithmetic, same
:func:`repro_torch.core.scheduler.masked_argmin` tie-break.

:func:`simulate_stream` is the event loop tying the pieces together:
arrival events admit tasks, completion events free nodes (optionally
migrating the tail of the most backlogged queue onto the freed node),
link events drift the per-node uplinks (:class:`repro_torch.sim.state.
ClusterLinks`) and the device↔edge split environment
(:class:`repro_torch.sim.state.DriftingEnv`).  Results land in a
:class:`repro_torch.sim.telemetry.Telemetry`.

The event heap, the finish matrix and the placements are host code, the
reference's f64 arithmetic in its order; the ETC rows a cost model
predicts and the split decisions run on the torch ``device`` (None =
cuda).  Not ported yet (ROADMAP.md §1 item 6), and raising
``NotImplementedError``: finite-capacity pools (``pools=``), sampled RTTs
(``rtt=``), the Pareto split planner (``split_planner=``,
``saturation_threshold=``), ``split_backend="sharded"`` and
``engine="fleet"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import scheduler as sch
from repro_torch.obs.trace import NULL_TRACER, postmortem_dump
from repro_torch.sim import fleet
from repro_torch.sim.events import EventQueue
from repro_torch.sim.state import ClusterLinks, DriftingEnv
from repro_torch.sim.telemetry import TaskRecord, Telemetry

#: what a not-yet-ported option raises
PENDING = ("{} is not ported yet (ROADMAP.md §1 item 6: sim/queueing.py, "
           "sim/pareto.py and the fleet engine come in a later slice)")


def _batches_by_arrival(arrivals: np.ndarray
                        ) -> list[tuple[float, list[int]]]:
    """``(time, task indices)`` admission batches: arrival order, exact
    time ties grouped into one batch (stable within a batch)."""
    order = np.argsort(arrivals, kind="stable")
    out: list[tuple[float, list[int]]] = []
    k = 0
    while k < len(order):
        m = k
        t = float(arrivals[order[k]])
        while m < len(order) and arrivals[order[m]] == t:
            m += 1
        out.append((t, [int(i) for i in order[k:m]]))
        k = m
    return out


class StreamScheduler:
    """Incremental online min-min / HEFT placement.

    ``policy`` is ``"min_min"`` (globally smallest finish first, the
    classic online heuristic) or ``"heft"`` (rank arriving batch by mean
    ETC descending, place each on its earliest-finish node).  ``cost``
    plugs a :class:`repro_torch.core.costs.CostModel` into the ETC rows
    (predictor-driven or multi-objective streaming placement), evaluated
    on the torch ``device`` (None = cuda); ``None`` keeps the analytic
    roofline estimate.  ``rebalance=True`` lets :meth:`on_node_free`
    migrate the tail of the most backlogged queue onto a freed node when
    that strictly improves its finish time.
    """

    def __init__(self, nodes: Sequence[sch.Node], *,
                 policy: str = "min_min", cost=None,
                 rebalance: bool = False, pools=None,
                 telemetry: Optional[Telemetry] = None,
                 device: DeviceLike = None):
        if policy not in ("min_min", "heft"):
            raise ValueError(f"unknown policy {policy!r}; "
                             "use 'min_min' or 'heft'")
        if pools is not None:
            raise NotImplementedError(PENDING.format("pools="))
        self.device = resolve_device(device)
        self.policy = policy
        self.cost = cost
        self.rebalance = rebalance
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.nodes = [dataclasses.replace(n) for n in nodes]
        self.avail = np.asarray([n.available_at for n in self.nodes],
                                np.float64)
        self.assignments: list[sch.Assignment] = []
        self._node_of: dict[int, int] = {}       # id(assignment) -> node j
        self._etc_of: dict[int, float] = {}      # id(assignment) -> etc
        # incremental-work counters (full_rebuilds stays 0 by construction)
        self.rows_built = 0
        self.column_refreshes = 0
        self.link_refreshes = 0
        self.migrations = 0
        self.full_rebuilds = 0

    # -- ETC rows against the *current* node/link state -------------------
    def etc_rows(self, tasks: Sequence[sch.Task]) -> np.ndarray:
        """``[P, N]`` expected-time-to-compute of the arriving batch on
        every node, at the current link state."""
        etc = sch.etc_matrix(tasks, self.nodes, cost=self.cost,
                             device=self.device)
        self.rows_built += len(tasks)
        return np.asarray(etc, np.float64)

    def set_link_bw(self, j: int, bw: float) -> None:
        """Drift node ``j``'s uplink: future ETC columns see ``bw``.
        Committed work keeps its transfer (already in flight)."""
        node = self.nodes[j]
        node.spec = dataclasses.replace(node.spec, link_bw=float(bw))
        self.link_refreshes += 1
        self.telemetry.count("link_refreshes")

    # -- admission --------------------------------------------------------
    def on_arrivals(self, tasks: Sequence[sch.Task], now: float = 0.0
                    ) -> list[sch.Assignment]:
        """Place an arriving batch (all tasks have arrival time ``now``).

        One ETC row per task, then min-min rounds over the masked finish
        matrix (or HEFT ranking); every placement refreshes only the
        placed node's column.  Returns the new assignments in placement
        order.
        """
        tasks = list(tasks)
        if not tasks:
            return []
        # queue-aware cost models price the wait as of the admission
        # instant (QueueAwareCost reads live pool state through set_now)
        if self.cost is not None and hasattr(self.cost, "set_now"):
            self.cost.set_now(now)
        etc = self.etc_rows(tasks)
        placed: list[sch.Assignment] = []
        self.telemetry.count("replans")
        if self.policy == "heft":
            order = np.argsort(-etc.mean(axis=1))
            for i in order:
                j = int(np.argmin(np.maximum(self.avail, now) + etc[i]))
                start = float(np.maximum(self.avail[j], now))
                finish = start + float(etc[i, j])
                self.avail[j] = finish
                placed.append(self._commit(tasks[int(i)], j, start,
                                           finish, float(etc[i, j])))
            return placed
        fin = np.maximum(self.avail, now)[None, :] + etc
        active = np.ones(len(tasks), bool)
        for _ in range(len(tasks)):
            i, j = sch.masked_argmin(fin, active)
            start = float(np.maximum(self.avail[j], now))
            finish = float(fin[i, j])
            self.avail[j] = fin[i, j]
            active[i] = False
            fin[:, j] = np.maximum(self.avail[j], now) + etc[:, j]
            self.column_refreshes += 1
            self.telemetry.count("column_refreshes")
            placed.append(self._commit(tasks[i], j, start, finish,
                                       float(etc[i, j])))
        return placed

    def _commit(self, task: sch.Task, j: int, start: float, finish: float,
                etc_tj: float) -> sch.Assignment:
        a = sch.Assignment(task, self.nodes[j].spec.name, start, finish)
        self.assignments.append(a)
        self._node_of[id(a)] = j
        self._etc_of[id(a)] = etc_tj
        return a

    def etc_of(self, a: sch.Assignment) -> float:
        """The exact ETC value an assignment was placed with — the
        prediction an online oracle compares realised times against
        (recomputing it can disagree in the last ulp)."""
        return self._etc_of[id(a)]

    # -- node-free events -------------------------------------------------
    def node_index(self, a: sch.Assignment) -> int:
        """Node index an assignment currently sits on (spec names may
        repeat across nodes, so the name alone is not enough)."""
        return self._node_of[id(a)]

    def on_node_free(self, j: int, now: float
                     ) -> Optional[sch.Assignment]:
        """A task on node ``j`` just finished.  With ``rebalance=True``,
        try migrating the tail (last queued, not-yet-started) assignment
        of the most backlogged other node onto ``j`` when that strictly
        improves its finish; returns the migrated assignment (whose
        ``node``/``start``/``finish`` were updated in place), else
        ``None``."""
        if not self.rebalance:
            return None
        tails: dict[int, sch.Assignment] = {}
        for a in self.assignments:
            k = self._node_of[id(a)]
            if k != j and a.start > now and a.finish == self.avail[k]:
                tails[k] = a
        if not tails:
            return None
        k = max(tails, key=lambda k_: self.avail[k_])
        a = tails[k]
        etc_new = float(self.etc_rows([a.task])[0, j])
        start = float(np.maximum(self.avail[j], now))
        finish = start + etc_new
        if finish >= a.finish:
            return None
        self.avail[k] = a.start          # contiguous queue: tail pops off
        self.avail[j] = finish
        a.node = self.nodes[j].spec.name
        a.start, a.finish = start, finish
        self._node_of[id(a)] = j
        self._etc_of[id(a)] = etc_new
        self.migrations += 1
        self.telemetry.count("migrations")
        return a

    # -- conveniences -----------------------------------------------------
    def run(self, tasks: Sequence[sch.Task], arrivals) -> sch.Schedule:
        """Admit ``tasks`` at their ``arrivals`` times (batching ties)
        without the full event loop — the benchmark / equivalence path."""
        arrivals = np.asarray(arrivals, np.float64)
        if arrivals.shape != (len(tasks),):
            raise ValueError(
                f"arrivals must be [{len(tasks)}], got {arrivals.shape}")
        for t, batch in _batches_by_arrival(arrivals):
            self.on_arrivals([tasks[i] for i in batch], t)
        return self.schedule()

    def schedule(self) -> sch.Schedule:
        return sch.Schedule(list(self.assignments))


# --------------------------------------------------------------------------
# The event loop
# --------------------------------------------------------------------------
LayersFor = Union[Sequence, Callable[[sch.Task], Sequence]]


def simulate_stream(tasks: Sequence[sch.Task], arrivals,
                    nodes: Sequence[sch.Node], *,
                    policy: str = "min_min", cost=None,
                    oracle=None, service_time_fn=None,
                    links: Optional[ClusterLinks] = None,
                    link_update_dt: float = 1.0,
                    split_planner=None,
                    split_env: Optional[DriftingEnv] = None,
                    split_layers: Optional[LayersFor] = None,
                    split_cost=None, split_backend: str = "kernel",
                    rebalance: bool = False,
                    pools=None, rtt=None,
                    saturation_threshold: Optional[float] = None,
                    telemetry: Optional[Telemetry] = None,
                    obs=None,
                    engine: str = "event",
                    device: DeviceLike = None) -> Telemetry:
    """Run the full event-driven streaming simulation.

    Events, in virtual-time order with FIFO ties:

      * ``arrive``  — admit the batch of tasks arriving at that instant
                      through the incremental :class:`StreamScheduler`
      * ``finish``  — a task completes: record telemetry, free the node
                      (possibly migrating a queued task onto it)
      * ``link``    — every ``link_update_dt`` seconds of virtual time,
                      drift the per-node uplinks (``links``) and the
                      device↔edge environment (``split_env``), refreshing
                      only the affected ETC columns

    ``service_time_fn(task, node_spec, etc_s, start_s) -> seconds``
    injects a ground-truth service-time model *independent of the
    scheduler's prediction*: the scheduler still queues and places by
    its believed ETC, but each task's completion event fires at
    ``start + actual``, and telemetry/energy/oracle observations record
    the realised time.  ``start_s`` lets the truth drift mid-run.

    ``oracle`` plugs an :class:`repro_torch.oracle.online.OnlineOracle`
    into the loop: its :class:`~repro_torch.oracle.online.OracleCost`
    drives the scheduler's ETC rows, and every completion feeds
    ``(features, realised service time)`` back through ``observe_task``
    — residual correction, Page–Hinkley drift detection, and window
    refits on the oracle's torch device (telemetry counts
    ``oracle_observations`` / ``oracle_drift_triggers`` /
    ``oracle_refits`` and gauges ``oracle_nrmse``).  Features and the
    transfer estimate are taken from the node spec *at placement*.  With
    a static environment, no ``service_time_fn``, and no drift the oracle
    is bit-transparent: placements are identical to running the same
    fitted model as a plain ``cost=PredictorCost(...)``.

    Passing ``split_env=`` + ``split_layers=`` enables
    *decide-at-admission*: each placed task's offload split is decided
    once via :func:`repro_torch.core.decisions.decide_all` against the
    link observation at its arrival (optionally under ``split_cost=``;
    ``split_backend=`` is ``"kernel"``, the ``decide_split`` kernel, or
    ``"torch"``, the exact f64 sweep) and recorded on its
    :class:`TaskRecord`.

    ``obs=`` takes a duck-typed tracer (``enabled``, ``instant``,
    ``task_spans``, ``last``; a ``repro.obs`` tracer fits) that records
    the run in *virtual time*; the default no-op tracer costs nothing.
    On an exception the loop writes a flight-recorder post-mortem
    (:func:`repro_torch.obs.trace.postmortem_dump`, tracing on only) and
    re-raises.

    The ETC rows and split decisions run on the torch ``device`` (None =
    cuda, raising without a card).  ``pools=``, ``rtt=``,
    ``split_planner=``, ``saturation_threshold=``,
    ``split_backend="sharded"`` and ``engine="fleet"`` raise
    ``NotImplementedError`` (ROADMAP.md §1 item 6).

    Returns the filled :class:`Telemetry` (the scheduler's counters and
    one :class:`TaskRecord` per task).
    """
    if engine == "fleet":
        raise NotImplementedError(PENDING.format("engine='fleet'"))
    if engine != "event":
        raise ValueError(f"unknown engine {engine!r}; "
                         "use 'event' or 'fleet'")
    for name, value in (("pools=", pools), ("rtt=", rtt),
                        ("split_planner=", split_planner),
                        ("saturation_threshold=", saturation_threshold)):
        if value is not None:
            raise NotImplementedError(PENDING.format(name))
    dev = resolve_device(device)
    telemetry = telemetry if telemetry is not None else Telemetry()
    obs = obs if obs is not None else NULL_TRACER
    if oracle is not None:
        if cost is not None:
            raise ValueError("pass either cost= or oracle= — the oracle "
                             "supplies the scheduler's cost model "
                             "(oracle.cost_model())")
        cost = oracle.cost_model()
        oracle.telemetry = telemetry           # counters/gauges per run
        oracle.obs = obs                       # drift/refit instants
        oracle.registry.obs = obs              # publish instants
    decide_splits = split_env is not None and split_layers is not None
    if split_cost is not None and not decide_splits:
        raise ValueError("split_cost= needs split_env= and "
                         "split_layers=")
    split_of: dict[int, int] = {}              # rid -> admission split

    def layers_for(task: sch.Task):
        if callable(split_layers):
            return split_layers(task)
        return split_layers

    sched = StreamScheduler(nodes, policy=policy, cost=cost,
                            rebalance=rebalance, telemetry=telemetry,
                            device=dev)
    arrivals = np.asarray(arrivals, np.float64)
    if arrivals.shape != (len(tasks),):
        raise ValueError(
            f"arrivals must be [{len(tasks)}], got {arrivals.shape}")

    q = EventQueue()
    batches = _batches_by_arrival(arrivals)
    q.push_batch([t for t, _ in batches], "arrive",
                 [batch for _, batch in batches])
    drifting = (links is not None or split_env is not None) \
        and link_update_dt > 0
    if drifting:
        q.push(link_update_dt, "link", None)

    to_arrive = len(tasks)
    live: dict[int, sch.Assignment] = {}         # rid -> assignment
    rid_of: dict[int, int] = {}                  # id(assignment) -> rid
    completed: set[int] = set()                  # id(assignment)
    spec_at_place: dict[int, object] = {}        # id(a) -> spec at placement
    real_finish: dict[int, float] = {}           # id(a) -> realised finish

    def schedule_finish(a: sch.Assignment) -> None:
        """Queue the completion event: at the believed finish, or at
        ``start + actual`` when a ground-truth model rides along (the
        scheduler's queue bookkeeping stays belief-driven)."""
        j = sched.node_index(a)
        spec_at_place[id(a)] = sched.nodes[j].spec
        t = a.finish
        if service_time_fn is not None:
            t = a.start + float(service_time_fn(a.task,
                                                sched.nodes[j].spec,
                                                sched.etc_of(a), a.start))
        real_finish[id(a)] = t
        q.push(t, "finish", a)

    now = 0.0
    try:
        while q:
            ev = q.pop()
            now = ev.time
            if ev.kind == "arrive":
                batch = [tasks[i] for i in ev.payload]
                # map task objects back to their global indices (pick order
                # of the placements differs from input order)
                slots: dict[int, list[int]] = {}
                for rid, task in zip(ev.payload, batch):
                    slots.setdefault(id(task), []).append(rid)
                placed = sched.on_arrivals(batch, now)
                to_arrive -= len(batch)
                if obs.enabled:
                    obs.instant("scheduler", "replan", now,
                                args={"batch": len(batch)})
                for a in placed:
                    rid = slots[id(a.task)].pop(0)
                    live[rid] = a
                    rid_of[id(a)] = rid
                    schedule_finish(a)
                    if decide_splits:
                        plan = fleet._split_decide(
                            layers_for(a.task),
                            split_env.snapshot(a.task.input_bytes),
                            split_cost, split_backend)
                        split_of[rid] = int(plan.splits[0])
                        telemetry.count("split_decides")
            elif ev.kind == "finish":
                a = ev.payload
                if id(a) in completed or real_finish[id(a)] != now:
                    continue                         # stale (migrated) event
                completed.add(id(a))
                rid = rid_of[id(a)]
                j = sched.node_index(a)
                if oracle is not None:
                    # realised service time vs the exact ETC it was placed
                    # with — the profiling-in-the-loop feedback edge.  The
                    # placement-time spec keeps features/transfer consistent
                    # with what the prediction actually saw.
                    oracle.observe_task(a.task, spec_at_place[id(a)],
                                        realised_s=now - a.start,
                                        predicted_s=sched.etc_of(a),
                                        now=now)
                split = split_of.pop(rid) if decide_splits else None
                telemetry.complete(TaskRecord(
                    name=a.task.name, arrived_s=float(arrivals[rid]),
                    started_s=a.start, finished_s=now, node=a.node,
                    node_id=j, deadline_s=a.task.deadline_s,
                    energy_j=(now - a.start)
                    * sched.nodes[j].spec.tdp_watts,
                    split=split))
                if obs.enabled:
                    span_args = {}
                    if split is not None:
                        span_args["split"] = split
                    if a.task.deadline_s is not None:
                        span_args["deadline_s"] = a.task.deadline_s
                    obs.task_spans(
                        f"{a.node}@{j}", rid, a.task.name,
                        float(arrivals[rid]), a.start, now,
                        transfer_s=0.0, args=span_args or None)
                del live[rid]
                migrated = sched.on_node_free(j, now)
                if migrated is not None:
                    schedule_finish(migrated)
            elif ev.kind == "link":
                if links is not None:
                    prev = links.values()
                    bws = links.step(link_update_dt)
                    changed = np.flatnonzero(bws != prev)
                    for j in changed:
                        sched.set_link_bw(int(j), float(bws[j]))
                    if obs.enabled and len(changed):
                        obs.instant("scheduler", "link_drift", now,
                                    args={"nodes": int(len(changed))})
                if split_env is not None:
                    split_env.step(link_update_dt)
                if to_arrive > 0 or live:
                    q.push(now + link_update_dt, "link", None)
    except Exception as e:
        # flight-recorder post-mortem: dump the recent traced history and
        # the virtual clock, then re-raise (a no-op with tracing off)
        postmortem_dump(obs, clock_s=now,
                        error=f"{type(e).__name__}: {e}")
        raise
    return telemetry
