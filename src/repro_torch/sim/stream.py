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
(:class:`repro_torch.sim.state.DriftingEnv`), and a
:class:`repro_torch.sim.pareto.ParetoStreamScheduler` may ride along to
keep each live task's offload split on the Pareto front.  Results land in
a :class:`repro_torch.sim.telemetry.Telemetry`.

The event heap, the finish matrix, the server pools
(:mod:`repro_torch.sim.queueing`) and the placements are host code, the
reference's f64 arithmetic in its order; the ETC rows a cost model
predicts, the split decisions and the planner's fronts run on the torch
``device`` (None = cuda).
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
    that strictly improves its finish time.  ``pools`` (a
    :class:`repro_torch.sim.queueing.NodePools`) routes every placement
    through a finite-capacity server pool, the realised service drawn at
    admission from ``service_time_fn``.
    """

    def __init__(self, nodes: Sequence[sch.Node], *,
                 policy: str = "min_min", cost=None,
                 rebalance: bool = False,
                 pools=None, service_time_fn=None,
                 telemetry: Optional[Telemetry] = None,
                 device: DeviceLike = None):
        if policy not in ("min_min", "heft"):
            raise ValueError(f"unknown policy {policy!r}; "
                             "use 'min_min' or 'heft'")
        self.device = resolve_device(device)
        self.policy = policy
        self.cost = cost
        self.rebalance = rebalance
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.nodes = [dataclasses.replace(n) for n in nodes]
        self.pools = pools
        self.service_time_fn = service_time_fn
        if pools is not None:
            if rebalance:
                raise ValueError(
                    "rebalance=True is incompatible with pools= — "
                    "migration bookkeeping assumes the believed scalar "
                    "queue, not realised c-server busy state")
            if len(pools) != len(self.nodes):
                raise ValueError(f"pools carries {len(pools)} pools for "
                                 f"{len(self.nodes)} nodes")
            # the availability vector IS the pools' earliest-free cache:
            # admissions update it in place through NodePools.admit
            self.avail = pools.avail
        else:
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
                if self.pools is not None:
                    start, finish = self._admit(tasks[int(i)], j, now,
                                                float(etc[i, j]))
                else:
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
            if self.pools is not None:
                start, finish = self._admit(tasks[i], j, now,
                                            float(etc[i, j]))
            else:
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

    def _admit(self, task: sch.Task, j: int, now: float,
               etc_tj: float) -> tuple[float, float]:
        """Route one placement through node ``j``'s server pool.

        The realised service time is drawn *at admission* (the pool
        tracks realised busy-until state, so queue statistics come out
        exact); ``self.avail`` is the pools' earliest-free cache and is
        updated in place by ``NodePools.admit``.  With ``capacity=1``
        and no ``service_time_fn`` this is bit-for-bit the historical
        scalar bookkeeping: ``start = max(avail[j], now)``,
        ``avail[j] = start + etc``.
        """
        service = etc_tj
        if self.service_time_fn is not None:
            start_pred = max(self.pools.pools[j].next_free(), float(now))
            service = float(self.service_time_fn(
                task, self.nodes[j].spec, etc_tj, start_pred))
        return self.pools.admit(j, now, service)

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
                      (and, when a ``split_planner`` rides along, admit
                      each task's offload split against the current
                      ``split_env`` link observation)
      * ``finish``  — a task completes: record telemetry, free the node
                      (possibly migrating a queued task onto it), close
                      the task's split plan
      * ``link``    — every ``link_update_dt`` seconds of virtual time,
                      drift the per-node uplinks (``links``) and the
                      device↔edge environment (``split_env``), refresh
                      only the affected ETC columns, and let the split
                      planner re-pick along the live Pareto fronts

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

    Without a ``split_planner``, passing ``split_env=`` +
    ``split_layers=`` enables *decide-at-admission*: each placed task's
    offload split is decided once via :func:`repro_torch.core.decisions.
    decide_all` against the link observation at its arrival (optionally
    under ``split_cost=``; ``split_backend=`` is ``"kernel"``, the
    ``decide_split`` kernel, ``"torch"``, the exact f64 sweep, or
    ``"sharded"``, :func:`repro_torch.sim.fleet.decide_all_sharded`) and
    recorded on its :class:`TaskRecord`.

    ``pools=`` (a :class:`repro_torch.sim.queueing.NodePools`) replaces
    the believed scalar queue with finite-capacity c-server FIFO pools
    tracking *realised* busy state: sojourn = queue wait + service
    (+ transfer).  With pools the realised service time
    (``service_time_fn``) is drawn *at admission*; ``capacity=1`` with no
    service model is bit-for-bit the historical bookkeeping.  ``rtt=`` (a
    :class:`repro_torch.sim.queueing.DelayProcess`) samples one
    heavy-tailed network round-trip per task, delaying its completion
    event and booked as the record's ``transfer_s``.
    ``saturation_threshold=`` (needs ``split_planner=`` and ``pools=``)
    fires ``split_planner.on_saturation`` whenever any pool's utilisation
    crosses the threshold from below.

    ``obs=`` takes a :class:`repro_torch.obs.Tracer`, which records the
    run in *virtual time* (lifecycle spans per task; replan, link-drift,
    pool and oracle instants); the default no-op tracer costs nothing.
    On an exception the loop writes a flight-recorder post-mortem
    (:func:`repro_torch.obs.trace.postmortem_dump`, tracing on only) and
    re-raises.

    ``engine="fleet"`` dispatches the whole run to
    :func:`repro_torch.sim.fleet.simulate_fleet`, the time-slabbed twin
    of this loop — bit-for-bit equal telemetry in f64, but rejecting the
    inherently sequential features (``oracle=``, ``rebalance=True``,
    ``cost=``, ``saturation_threshold=``).

    The ETC rows and split decisions run on the torch ``device`` (None =
    cuda, raising without a card).

    Returns the filled :class:`Telemetry` (the scheduler's counters and
    one :class:`TaskRecord` per task).
    """
    if engine == "fleet":
        return fleet.simulate_fleet(
            tasks, arrivals, nodes, policy=policy, cost=cost,
            oracle=oracle, service_time_fn=service_time_fn, links=links,
            link_update_dt=link_update_dt, split_planner=split_planner,
            split_env=split_env, split_layers=split_layers,
            split_cost=split_cost, split_backend=split_backend,
            rebalance=rebalance, pools=pools, rtt=rtt,
            saturation_threshold=saturation_threshold,
            telemetry=telemetry, obs=obs, device=device)
    if engine != "event":
        raise ValueError(f"unknown engine {engine!r}; "
                         "use 'event' or 'fleet'")
    if saturation_threshold is not None and (
            split_planner is None or pools is None):
        raise ValueError("saturation_threshold= needs split_planner= "
                         "and pools= (it re-picks splits when pool "
                         "utilisation crosses the threshold)")
    dev = resolve_device(device)
    telemetry = telemetry if telemetry is not None else Telemetry()
    obs = obs if obs is not None else NULL_TRACER
    if pools is not None:
        pools.obs = obs
    if oracle is not None:
        if cost is not None:
            raise ValueError("pass either cost= or oracle= — the oracle "
                             "supplies the scheduler's cost model "
                             "(oracle.cost_model())")
        cost = oracle.cost_model()
        oracle.telemetry = telemetry           # counters/gauges per run
        oracle.obs = obs                       # drift/refit instants
        oracle.registry.obs = obs              # publish instants
    if split_planner is not None:
        if split_env is None or split_layers is None:
            raise ValueError("split_planner needs split_env= and "
                             "split_layers= (shared list or task -> "
                             "layers)")
        if split_cost is not None:
            raise ValueError("split_cost= only applies to the "
                             "decide-at-admission path (no "
                             "split_planner)")
        split_planner.telemetry = telemetry    # one record per run
        split_planner.obs = obs                # split re-pick instants
    decide_splits = (split_planner is None and split_env is not None
                     and split_layers is not None)
    if split_cost is not None and not decide_splits:
        raise ValueError("split_cost= needs split_env= and "
                         "split_layers= without a split_planner")
    split_of: dict[int, int] = {}              # rid -> admission split

    def layers_for(task: sch.Task):
        if callable(split_layers):
            return split_layers(task)
        return split_layers

    sched = StreamScheduler(nodes, policy=policy, cost=cost,
                            rebalance=rebalance, pools=pools,
                            service_time_fn=service_time_fn,
                            telemetry=telemetry, device=dev)
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
    rtt_of: dict[int, float] = {}                # id(a) -> sampled RTT
    sat_was = False                              # saturation edge detector

    def schedule_finish(a: sch.Assignment) -> None:
        """Queue the completion event: at the believed finish, or at
        ``start + actual`` when a ground-truth model rides along (the
        scheduler's queue bookkeeping stays belief-driven).  With pools
        the realised service was already drawn at admission, so
        ``a.finish`` *is* the realised compute finish; a heavy-tailed
        ``rtt`` sample then delays the completion event further."""
        j = sched.node_index(a)
        spec_at_place[id(a)] = sched.nodes[j].spec
        t = a.finish
        if pools is None and service_time_fn is not None:
            t = a.start + float(service_time_fn(a.task,
                                                sched.nodes[j].spec,
                                                sched.etc_of(a), a.start))
        if rtt is not None:
            r = float(rtt.sample(1)[0])
            rtt_of[id(a)] = r
            t += r
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
                    if split_planner is not None:
                        split_planner.admit(
                            rid, layers_for(a.task), split_env.link_bw,
                            input_bytes=a.task.input_bytes, now=now,
                            deadline_s=a.task.deadline_s)
                    elif decide_splits:
                        plan = fleet._split_decide(
                            layers_for(a.task),
                            split_env.snapshot(a.task.input_bytes),
                            split_cost, split_backend)
                        split_of[rid] = int(plan.splits[0])
                        telemetry.count("split_decides")
                if saturation_threshold is not None:
                    sat_now = bool(pools.saturated(
                        now, saturation_threshold).any()) if now > 0 \
                        else False
                    if sat_now and not sat_was:
                        if obs.enabled:
                            obs.instant("scheduler", "pool_saturation", now,
                                        args={"threshold":
                                              saturation_threshold})
                        split_planner.on_saturation(split_env.link_bw,
                                                    now=now)
                    sat_was = sat_now
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
                                        predicted_s=sched.etc_of(a), now=now,
                                        extra_transfer_s=rtt_of.get(id(a),
                                                                    0.0))
                split, switches = None, 0
                if split_planner is not None:
                    rec = split_planner.complete(rid, split_env.link_bw,
                                                 now=now)
                    split, switches = rec["pick"], rec["switches"]
                elif decide_splits:
                    split = split_of.pop(rid)
                telemetry.complete(TaskRecord(
                    name=a.task.name, arrived_s=float(arrivals[rid]),
                    started_s=a.start, finished_s=now, node=a.node,
                    node_id=j, deadline_s=a.task.deadline_s,
                    energy_j=(now - a.start)
                    * sched.nodes[j].spec.tdp_watts,
                    split=split, switches=switches,
                    transfer_s=rtt_of.get(id(a), 0.0)))
                if obs.enabled:
                    span_args = {}
                    if split is not None:
                        span_args["split"] = split
                    if a.task.deadline_s is not None:
                        span_args["deadline_s"] = a.task.deadline_s
                    obs.task_spans(
                        f"{a.node}@{j}", rid, a.task.name,
                        float(arrivals[rid]), a.start, now,
                        transfer_s=rtt_of.get(id(a), 0.0),
                        args=span_args or None)
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
                    if split_planner is not None:
                        split_planner.on_link(split_env.link_bw, now=now)
                if to_arrive > 0 or live:
                    q.push(now + link_update_dt, "link", None)
    except Exception as e:
        # flight-recorder post-mortem: dump the recent traced history and
        # the virtual clock, then re-raise (a no-op with tracing off)
        postmortem_dump(obs, clock_s=now,
                        error=f"{type(e).__name__}: {e}")
        raise
    return telemetry
