"""Fleet-scale time-slabbed simulation — the array-native twin of the
host event loop, the port of ``repro.sim.fleet``.

:func:`repro_torch.sim.stream.simulate_stream` walks a heap one event at a
time.  This module drains the same virtual timeline in *slabs* — the spans
between link ticks, inside which every per-node bandwidth is constant:

  * link drift: one batched ``step_batch`` per process for the whole
    run (:mod:`repro_torch.sim.state`), giving the full ``[K, N]``
    bandwidth trajectory and the per-tick changed-node masks as array ops;
  * arrivals: the ETC rows of every task arriving in a slab come from
    one broadcast over the slab's effective-bandwidth row; a run of at
    least ``_SCAN_MIN`` single-task batches is placed by the
    ``fleet_scan`` kernel on the card (its plain twin on the CPU);
  * offload splits: all tasks admitted in a slab that share a layer
    chain are decided in ONE ``decide_all`` call (``split_backend=`` is
    ``"kernel"``, ``"torch"`` or ``"sharded"``);
  * completions: telemetry lands as column batches
    (:meth:`repro_torch.sim.telemetry.Telemetry.complete_arrays`), ordered
    by the exact (finish time, placement sequence) pop order of the heap.

The host loop stays the reference: :func:`simulate_fleet` is bit-for-bit
equal to it in f64 — same seeds, same arrival batching, same FIFO tie
semantics.  Two orderings the heap makes implicit are reproduced in closed
form: arrivals always pop before a link tick at the same instant (their
sequence numbers predate every tick's), and a task finishing exactly on a
tick keeps that tick's re-push alive iff its finish event was pushed after
the tick (it arrived after the previous tick).  A ``ParetoStreamScheduler``
re-picks against the live set, so with ``split_planner=`` the timeline is
replayed through a lightweight heap (same (time, seq) discipline) with
slab-batched admissions.

The bookkeeping (batching, tick chain, pools, RTT draws, the replay) is
host numpy, as in the reference; the card runs the singleton runs and the
split decisions.  Inherently sequential features are rejected:
``oracle=``, ``rebalance=True``, ``cost=`` and ``saturation_threshold=``
need ``engine="event"``.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import decisions as dec
from repro_torch.core import scheduler as sch
from repro_torch.core.offload import DEFAULT_EFFICIENCY
from repro_torch.kernels.fleet_scan import ops as scan_ops
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sim.state import ClusterLinks, DriftingEnv
from repro_torch.sim.telemetry import Telemetry

#: tick-chain generation block (amortises the cumsum over many slabs)
_TICK_CHUNK = 8192

#: singleton-batch placement runs at least this long go to the
#: ``fleet_scan`` kernel (the reference's threshold for its lax.scan)
_SCAN_MIN = 512


def decide_all_sharded(layers, envs: dec.EnvArrays,
                       efficiency: float = DEFAULT_EFFICIENCY, *,
                       mesh=None) -> dec.DecisionPlan:
    """``decide_all`` with the environment axis split across devices.

    On one card this is the exact f64 sweep,
    ``decide_all(backend="torch")`` on the envs' device — the reference
    also takes its plain path below two devices — so the plan is bit for
    bit the reference's numpy ``decide_all``.  A ``mesh=`` (several cards)
    is not ported yet: ROADMAP.md §1 item 9 step 2 (a torch
    ``DeviceMesh``)."""
    if mesh is not None:
        raise NotImplementedError(
            "decide_all_sharded(mesh=...) across several cards is not "
            "ported yet (ROADMAP.md §1 item 9 step 2: a torch DeviceMesh)")
    return dec.decide_all(layers, envs, efficiency, backend="torch",
                          device=envs.device)


def _split_decide(layers, envs, cost, backend) -> dec.DecisionPlan:
    """One admission group's split plan over ``envs`` (on their torch
    device): ``backend`` is ``"kernel"`` (the ``decide_split`` kernel),
    ``"torch"`` (the exact f64 sweep) or ``"sharded"``."""
    if backend == "sharded":
        if cost is not None:
            raise ValueError("split_backend='sharded' supports the "
                             "analytic cost only (cost models lower via "
                             "backend='kernel')")
        return decide_all_sharded(layers, envs)
    return dec.decide_all(layers, envs, cost=cost, backend=backend,
                          device=envs.device)


def simulate_fleet(tasks: Sequence[sch.Task], arrivals,
                   nodes: Sequence[sch.Node], *,
                   policy: str = "min_min", cost=None, oracle=None,
                   service_time_fn=None,
                   links: Optional[ClusterLinks] = None,
                   link_update_dt: float = 1.0,
                   split_planner=None,
                   split_env: Optional[DriftingEnv] = None,
                   split_layers=None, split_cost=None,
                   split_backend: str = "kernel",
                   rebalance: bool = False,
                   pools=None, rtt=None,
                   saturation_threshold: Optional[float] = None,
                   telemetry: Optional[Telemetry] = None,
                   obs=None, device: DeviceLike = None) -> Telemetry:
    """Time-slabbed streaming simulation, bit-for-bit (f64) equal to
    ``simulate_stream(..., engine="event")`` on every supported
    configuration — see the module docstring for what is drained as
    array ops and why ``oracle=`` / ``rebalance=`` / ``cost=`` are
    rejected.  Normally reached via ``simulate_stream(...,
    engine="fleet")``.

    ``pools=`` routes placements through finite-capacity
    :class:`repro_torch.sim.queueing.NodePools` (the singleton scan is
    skipped, since placements then depend on realised admissions), and
    ``rtt=`` adds one heavy-tailed network delay sample per task — both
    reproduce the host engine's draws exactly.  ``saturation_threshold=``
    is rejected: the utilisation-edge trigger is inherently per-event.
    Singleton runs go through ``fleet_scan`` on the torch ``device`` (None
    = cuda); split decisions run on the split environment's device.
    """
    if policy not in ("min_min", "heft"):
        raise ValueError(f"unknown policy {policy!r}; "
                         "use 'min_min' or 'heft'")
    if saturation_threshold is not None:
        raise ValueError(
            "engine='fleet' does not support saturation_threshold= — "
            "the pool-utilisation edge trigger fires mid-timeline, "
            "which is inherently per-event; use engine='event'")
    if pools is not None and len(pools) != len(nodes):
        raise ValueError(f"pools carries {len(pools)} pools for "
                         f"{len(nodes)} nodes")
    if oracle is not None:
        raise ValueError(
            "engine='fleet' does not support oracle= — online oracle "
            "observations feed back into later placements, which is "
            "inherently per-event; use engine='event'")
    if rebalance:
        raise ValueError(
            "engine='fleet' does not support rebalance=True — "
            "migrations couple completions back into placements; use "
            "engine='event'")
    if cost is not None:
        raise ValueError(
            "engine='fleet' vectorizes the analytic ETC only; cost= "
            "models run per-arrival on the host — use engine='event'")
    if split_planner is not None:
        if split_env is None or split_layers is None:
            raise ValueError("split_planner needs split_env= and "
                             "split_layers= (shared list or task -> "
                             "layers)")
        if not hasattr(split_planner, "admit_batch"):
            raise ValueError(
                "engine='fleet' needs a ParetoStreamScheduler-style "
                "planner (admit_batch / live); use engine='event' for "
                "custom planners")
        if split_cost is not None:
            raise ValueError("split_cost= only applies to the "
                             "decide-at-admission path (no "
                             "split_planner)")
    decide_splits = (split_planner is None and split_env is not None
                     and split_layers is not None)
    if split_cost is not None and not decide_splits:
        raise ValueError("split_cost= needs split_env= and "
                         "split_layers= without a split_planner")
    dev = resolve_device(device)

    telemetry = telemetry if telemetry is not None else Telemetry()
    obs = obs if obs is not None else NULL_TRACER
    if pools is not None:
        pools.obs = obs
    if split_planner is not None:
        split_planner.telemetry = telemetry
        split_planner.obs = obs

    def layers_for(task: sch.Task):
        if callable(split_layers):
            return split_layers(task)
        return split_layers

    arrivals = np.asarray(arrivals, np.float64)
    if arrivals.shape != (len(tasks),):
        raise ValueError(
            f"arrivals must be [{len(tasks)}], got {arrivals.shape}")
    n_tasks = len(tasks)
    specs0 = [n.spec for n in nodes]
    node_names = [s.name for s in specs0]
    peak_eff = np.asarray([s.peak_flops_f32 for s in specs0],
                          np.float64) * DEFAULT_EFFICIENCY
    spec_bw0 = np.asarray([s.link_bw for s in specs0], np.float64)
    tdp = np.asarray([s.tdp_watts for s in specs0], np.float64)
    # with pools the availability vector IS the pools' earliest-free
    # cache (admissions update it in place), exactly as in the host
    # StreamScheduler
    avail = pools.avail if pools is not None else \
        np.asarray([n.available_at for n in nodes], np.float64).copy()
    flops_t = np.asarray([t.flops for t in tasks], np.float64)
    ib_t = np.asarray([t.input_bytes for t in tasks], np.float64)

    # array-native arrival batching: same stable argsort + exact-time
    # grouping as stream._batches_by_arrival
    order = np.argsort(arrivals, kind="stable")
    sorted_t = arrivals[order]
    if n_tasks:
        starts = np.flatnonzero(np.concatenate(
            ([True], sorted_t[1:] != sorted_t[:-1])))
        offsets = np.concatenate([starts, [n_tasks]]).astype(np.intp)
        batch_times = sorted_t[starts]
    else:
        offsets = np.zeros(1, np.intp)
        batch_times = np.zeros(0, np.float64)
    n_batches = len(batch_times)
    sizes = np.diff(offsets)
    last_arrival = float(batch_times[-1]) if n_batches else -np.inf
    drifting = (links is not None or split_env is not None) \
        and link_update_dt > 0
    dt = float(link_update_dt)

    # -- tick time chain: the exact floats of the host's `now + dt`
    # re-push arithmetic (cumsum is the same sequential accumulation)
    tick_times = np.zeros(0, np.float64)

    def ticks_until(t_lim: float, at_least: int = 1) -> None:
        nonlocal tick_times
        if not drifting:
            return
        while tick_times.size < at_least or tick_times[-1] < t_lim:
            last = float(tick_times[-1]) if tick_times.size else 0.0
            block = np.cumsum(np.concatenate(
                ([last], np.full(_TICK_CHUNK, dt))))[1:]
            if block[-1] <= last:
                raise RuntimeError(
                    f"link_update_dt={dt} cannot advance virtual time "
                    f"past {last} in float64")
            tick_times = np.concatenate([tick_times, block])

    # ticks strictly before the last arrival are exactly the ones any
    # placement can observe (an arrival at a tick's instant pops first:
    # its sequence number predates every tick's)
    if np.isfinite(last_arrival):
        ticks_until(last_arrival)
    k1 = int(np.searchsorted(tick_times, last_arrival, side="left")) \
        if drifting and n_tasks else 0

    # -- slab 1..k1 bandwidth trajectories: one batched step per process
    v0 = links.values() if links is not None else None
    traj1 = links.step_batch(dt, k1) if links is not None else None
    sp_v0 = split_env.link.value if split_env is not None else None
    sp1 = split_env.step_batch(dt, k1) if decide_splits else None

    # effective per-node bandwidth rows: a node's spec keeps its
    # original link_bw until the process value first CHANGES (the host
    # only rebuilds specs for changed nodes), then tracks the process
    if links is not None and k1:
        prev1 = np.vstack([v0[None, :], traj1[:-1]])
        changed1 = traj1 != prev1
        ever1 = np.logical_or.accumulate(changed1, axis=0)
        eff_rows = np.vstack([spec_bw0[None, :],
                              np.where(ever1, traj1, spec_bw0[None, :])])
    else:
        changed1 = None
        eff_rows = spec_bw0[None, :]
    bwc_rows = np.maximum(eff_rows, 1.0)

    # -- placement-time node specs (original spec until the link process
    # first changes, then the drifted bandwidth), cached per (node, bw)
    spec_cache: dict[tuple, object] = {}

    def spec_at(j: int, seg: int):
        bw = float(eff_rows[seg if links is not None else 0, j])
        spec = spec_cache.get((j, bw))
        if spec is None:
            spec = specs0[j] if bw == specs0[j].link_bw else \
                dataclasses.replace(specs0[j], link_bw=bw)
            spec_cache[(j, bw)] = spec
        return spec

    def pool_admit(rid: int, j: int, t: float, etc_v: float,
                   seg: int) -> tuple[float, float]:
        """StreamScheduler._admit op-for-op: realised service drawn at
        admission, pool updates ``avail`` in place."""
        service = etc_v
        if service_time_fn is not None:
            start_pred = max(pools.pools[j].next_free(), t)
            service = float(service_time_fn(tasks[rid], spec_at(j, seg),
                                            etc_v, start_pred))
        return pools.admit(j, t, service)

    # -- placements: per slab, ETC rows in one broadcast; the min-min /
    # HEFT rounds replicate StreamScheduler.on_arrivals op-for-op
    seg_of_batch = np.searchsorted(tick_times[:k1], batch_times,
                                   side="left")
    p_rid = np.empty(n_tasks, np.intp)     # all indexed by placement seq
    p_j = np.empty(n_tasks, np.intp)
    p_start = np.empty(n_tasks, np.float64)
    p_fin = np.empty(n_tasks, np.float64)  # believed finish
    p_etc = np.empty(n_tasks, np.float64)
    p_seg = np.empty(n_tasks, np.intp)
    min_min = policy == "min_min"
    # tick segment for split decisions (p_seg) vs the row the node
    # bandwidths come from (seg_etc): identical when links drift, but a
    # split-only run still advances through tick segments while every
    # ETC row keeps the static spec bandwidths
    seg_etc = seg_of_batch if links is not None \
        else np.zeros(n_batches, np.intp)
    on_dev: dict = {}                  # bwc_rows and peak_eff, up once

    def place_run(bi: int, end: int):
        """Batches ``bi..end-1``, one task each, through ``fleet_scan`` on
        ``dev``: the inputs up, the placements home, once each."""
        if not on_dev:
            on_dev["rows"] = torch.as_tensor(bwc_rows, device=dev)
            on_dev["peak"] = torch.as_tensor(peak_eff, device=dev)
        rids = order[offsets[bi]:offsets[end]]          # one per batch
        av = torch.as_tensor(avail, device=dev)
        cols = [torch.as_tensor(np.ascontiguousarray(c), device=dev)
                for c in (batch_times[bi:end], flops_t[rids], ib_t[rids])]
        segs = torch.as_tensor(seg_etc[bi:end].astype(np.int64),
                               device=dev)
        res = scan_ops.place_singletons(av, on_dev["peak"], on_dev["rows"],
                                        *cols, segs)
        avail[:] = av.cpu().numpy()
        return rids, [r.cpu().numpy() for r in res]

    nonsingle = np.flatnonzero(sizes != 1)
    pos = 0
    bi = 0
    while bi < n_batches:
        # realised pool admissions are sequential host state — the
        # singleton scan only models the believed scalar queue
        if sizes[bi] == 1 and pools is None:
            nxt = np.searchsorted(nonsingle, bi)
            end = int(nonsingle[nxt]) if nxt < len(nonsingle) \
                else n_batches
            if end - bi >= _SCAN_MIN:
                rids, (j_r, s_r, f_r, e_r) = place_run(bi, end)
                sl = slice(pos, pos + (end - bi))
                p_rid[sl] = rids
                p_j[sl], p_start[sl], p_fin[sl], p_etc[sl] = \
                    j_r, s_r, f_r, e_r
                p_seg[sl] = seg_of_batch[bi:end]
                pos += end - bi
                bi = end
                continue
        t = float(batch_times[bi])
        members = order[offsets[bi]:offsets[bi + 1]]
        s = int(seg_of_batch[bi])
        bwc = bwc_rows[int(seg_etc[bi])]
        etc = flops_t[members, None] / peak_eff[None, :] \
            + ib_t[members, None] / bwc[None, :]
        n_b = len(members)
        placed_rows: list[tuple] = []      # (row, node, start, fin, etc)
        if n_b == 1:
            fin_row = np.maximum(avail, t) + etc[0]
            j = int(np.argmin(fin_row))
            if pools is not None:
                start, finish = pool_admit(int(members[0]), j, t,
                                           float(etc[0, j]), s)
            elif min_min:
                start = float(np.maximum(avail[j], t))
                finish = float(fin_row[j])
                avail[j] = fin_row[j]
            else:                          # HEFT: start + float(etc)
                start = float(np.maximum(avail[j], t))
                finish = start + float(etc[0, j])
                avail[j] = finish
            placed_rows.append((0, j, start, finish, float(etc[0, j])))
        elif min_min:
            fin = np.maximum(avail, t)[None, :] + etc
            active = np.ones(n_b, bool)
            for _ in range(n_b):
                i, j = sch.masked_argmin(fin, active)
                if pools is not None:
                    start, finish = pool_admit(int(members[i]), j, t,
                                               float(etc[i, j]), s)
                else:
                    start = float(np.maximum(avail[j], t))
                    finish = float(fin[i, j])
                    avail[j] = fin[i, j]
                active[i] = False
                fin[:, j] = np.maximum(avail[j], t) + etc[:, j]
                placed_rows.append((i, j, start, finish,
                                    float(etc[i, j])))
        else:
            rank = np.argsort(-etc.mean(axis=1))
            for i in rank:
                i = int(i)
                j = int(np.argmin(np.maximum(avail, t) + etc[i]))
                if pools is not None:
                    start, finish = pool_admit(int(members[i]), j, t,
                                               float(etc[i, j]), s)
                else:
                    start = float(np.maximum(avail[j], t))
                    finish = start + float(etc[i, j])
                    avail[j] = finish
                placed_rows.append((i, j, start, finish,
                                    float(etc[i, j])))
        # map placements back to task indices FIFO per task object (the
        # same batch may carry one object twice)
        slots: dict[int, list[int]] = {}
        for rid in members:
            slots.setdefault(id(tasks[rid]), []).append(rid)
        for i, j, start, finish, etcv in placed_rows:
            p_rid[pos] = slots[id(tasks[members[i]])].pop(0)
            p_j[pos] = j
            p_start[pos] = start
            p_fin[pos] = finish
            p_etc[pos] = etcv
            p_seg[pos] = s
            pos += 1
        bi += 1
    if n_batches:
        telemetry.count("replans", n_batches)
        if obs.enabled:
            # the replan instants the host loop emits per arrive event,
            # as one deferred column batch
            obs.instant_arrays("scheduler", "replan", batch_times,
                               args_cols={"batch": sizes})
    if min_min and n_tasks:
        telemetry.count("column_refreshes", n_tasks)

    # -- heavy-tailed network delay: one vectorized draw in placement
    # order (numpy Generators consume the bit stream identically for
    # sample(n) and n sequential sample(1) calls, and the RTT stream is
    # independent of the service stream, so this reproduces the host
    # engine's per-task draws exactly)
    rtt_draws = np.asarray(rtt.sample(n_tasks), np.float64) \
        if rtt is not None and n_tasks else None

    # -- realised finishes (with pools the realised service was already
    # consumed at admission, so the believed finish IS realised; else
    # the ground-truth seam runs per task against the placement slab's
    # effective-bandwidth spec)
    if pools is not None or service_time_fn is None:
        fin_real = p_fin if rtt_draws is None else p_fin + rtt_draws
    else:
        fin_real = np.empty(n_tasks, np.float64)
        for p in range(n_tasks):
            fin_real[p] = p_start[p] + float(service_time_fn(
                tasks[int(p_rid[p])], spec_at(int(p_j[p]),
                                              int(p_seg[p])),
                float(p_etc[p]), float(p_start[p])))
        if rtt_draws is not None:
            fin_real = fin_real + rtt_draws

    # -- how many ticks actually pop: every tick < T* re-pushes its
    # successor (arrivals or live tasks remain), the first tick >= T*
    # pops and usually stops; a task finishing exactly on it keeps one
    # more tick alive iff its finish event outranks the tick (arrived
    # after the previous tick)
    if drifting:
        t_star = max(last_arrival, float(fin_real.max())) if n_tasks \
            else -np.inf
        ticks_until(t_star if np.isfinite(t_star) else 0.0)
        k_low = int(np.searchsorted(tick_times, t_star, side="left")) \
            if n_tasks else 0
        k_pop = k_low + 1
        if n_tasks:
            t_bound = float(tick_times[k_low])
            t_prev = float(tick_times[k_low - 1]) if k_low else -np.inf
            ties = fin_real == t_bound
            if ties.any() and (arrivals[p_rid[ties]] > t_prev).any():
                k_pop += 1
    else:
        k_pop = 0

    # -- remaining link drift + per-tick changed-node refresh counts,
    # all as array ops over the [K, N] trajectory
    if links is not None and k_pop:
        traj2 = links.step_batch(dt, k_pop - k1)
        prev_last = traj1[-1] if k1 else v0
        changed2 = traj2 != np.vstack([prev_last[None, :], traj2[:-1]])
        n_refresh = int(changed2.sum()) \
            + (int(changed1.sum()) if changed1 is not None else 0)
        if n_refresh:
            telemetry.count("link_refreshes", n_refresh)
        if obs.enabled:
            per_tick = np.concatenate(
                [changed1.sum(axis=1) if changed1 is not None
                 else np.zeros(0, np.int64), changed2.sum(axis=1)])
            drifted = np.flatnonzero(per_tick)
            obs.instant_arrays("scheduler", "link_drift",
                               tick_times[drifted],
                               args_cols={"nodes": per_tick[drifted]})

    # -- offload splits: one decide_all per (tick segment, layer chain)
    split_by_rid: Optional[list] = None
    switches_by_rid: Optional[list] = None
    if decide_splits and n_tasks:
        split_env.step_batch(dt, k_pop - k1)     # advance to end state
        split_dev = resolve_device(split_env.torch_device)
        lay_by_rid = [layers_for(t) for t in tasks]
        groups: dict[tuple, list[int]] = {}
        for p in range(n_tasks):
            key = (int(p_seg[p]), id(lay_by_rid[int(p_rid[p])]))
            groups.setdefault(key, []).append(p)
        split_by_rid = [None] * n_tasks
        for (s, _lid), plist in groups.items():
            rids = p_rid[plist]
            lay = lay_by_rid[int(rids[0])]
            bw = sp_v0 if s == 0 else float(sp1[s - 1])
            envs = dec.make_envs(
                split_env.device, split_env.edge,
                link_bw=np.full(len(plist), bw),
                link_latency_s=split_env.link_latency_s,
                input_bytes=ib_t[rids], device=split_dev)
            plan = _split_decide(lay, envs, split_cost, split_backend)
            for k, split in enumerate(plan.splits.cpu().tolist()):
                split_by_rid[int(rids[k])] = int(split)
        telemetry.count("split_decides", n_tasks)
    elif split_planner is None and split_env is not None:
        split_env.step_batch(dt, k_pop)          # advance-only

    # -- planner replay: same (time, seq) heap discipline as the host,
    # but each pop is only the planner work — admissions slab-batched
    # per layer chain, completions pop the live state directly
    if split_planner is not None:
        split_by_rid = [None] * n_tasks
        switches_by_rid = [0] * n_tasks
        heap: list[tuple] = []
        seq = 0
        for bi in range(n_batches):
            heap.append((float(batch_times[bi]), seq, 0, bi))  # 0: arrive
            seq += 1
        if drifting:
            ticks_until(0.0)
            heap.append((float(tick_times[0]), seq, 2, 0))  # kind 2: link
            seq += 1
        heapq.heapify(heap)
        to_arrive = n_tasks
        live = 0
        ticks_done = 0
        while heap:
            t, _s, kind, payload = heapq.heappop(heap)
            if kind == 0:                        # arrive
                lo, hi = int(offsets[payload]), int(offsets[payload + 1])
                for p in range(lo, hi):          # finishes in place order
                    heapq.heappush(heap, (float(fin_real[p]), seq, 1, p))
                    seq += 1
                to_arrive -= hi - lo
                live += hi - lo
                order_keys: list[int] = []
                groups = {}
                for p in range(lo, hi):
                    rid = int(p_rid[p])
                    lay = layers_for(tasks[rid])
                    if id(lay) not in groups:
                        groups[id(lay)] = (lay, [])
                        order_keys.append(id(lay))
                    groups[id(lay)][1].append(rid)
                bw = split_env.link_bw
                for key in order_keys:
                    lay, rids = groups[key]
                    split_planner.admit_batch(
                        rids, lay, bw,
                        input_bytes=[tasks[r].input_bytes for r in rids],
                        now=t,
                        deadlines_s=[tasks[r].deadline_s for r in rids])
            elif kind == 1:                      # finish
                rid = int(p_rid[payload])
                st = split_planner.live.pop(rid)
                split_by_rid[rid] = st.pick
                switches_by_rid[rid] = st.switches
                live -= 1
            else:                                # link tick
                ticks_done += 1
                split_env.step(dt)
                split_planner.on_link(split_env.link_bw, now=t)
                if to_arrive > 0 or live > 0:
                    ticks_until(0.0, at_least=ticks_done + 1)
                    heapq.heappush(
                        heap, (float(tick_times[ticks_done]), seq, 2,
                               ticks_done))
                    seq += 1
        if drifting and ticks_done != k_pop:     # internal invariant
            raise AssertionError(
                f"fleet tick replay diverged from the closed form: "
                f"{ticks_done} ticks popped, expected {k_pop}")

    # -- telemetry: one column batch, in the exact pop order of the
    # host's finish events — (realised finish, placement seq)
    if n_tasks:
        ord_p = np.argsort(fin_real, kind="stable")
        rid_o = p_rid[ord_p]
        energy = (fin_real - p_start) * tdp[p_j]
        telemetry.complete_arrays(
            [tasks[r].name for r in rid_o],
            arrivals[rid_o], p_start[ord_p], fin_real[ord_p],
            node=[node_names[j] for j in p_j[ord_p]],
            node_id=p_j[ord_p],
            deadline_s=[tasks[r].deadline_s for r in rid_o],
            energy_j=energy[ord_p],
            split=None if split_by_rid is None
            else [split_by_rid[r] for r in rid_o],
            switches=None if switches_by_rid is None
            else [switches_by_rid[r] for r in rid_o],
            transfer_s=None if rtt_draws is None else rtt_draws[ord_p])
        if obs.enabled:
            # lifecycle spans as one deferred column batch, in the same
            # completion order the host engine emits them; deadline and
            # split ride as sojourn args (None entries drop per row).  Every
            # column is a fresh array or list (fancy-indexed here), which
            # the tracer holds unread until its first read
            args_cols = {
                "deadline_s": [tasks[r].deadline_s for r in rid_o],
                "split": None if split_by_rid is None
                else [split_by_rid[r] for r in rid_o],
            }
            obs.span_arrays(
                [f"{node_names[j]}@{j}" for j in p_j[ord_p]],
                rid_o, [tasks[r].name for r in rid_o],
                arrivals[rid_o], p_start[ord_p], fin_real[ord_p],
                transfer_s=None if rtt_draws is None
                else rtt_draws[ord_p],
                args_cols={k: v for k, v in args_cols.items()
                           if v is not None})
    return telemetry
