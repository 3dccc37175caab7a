"""Edge offloading simulation (paper §II-C + §II-D), on the port.

Sweeps link conditions for a CNN workload across heterogeneous devices,
compares all offloading policies (incl. the Q-learning controller), runs a
dense 4096-point link×device scenario sweep through the ``decide_split``
kernel, re-ranks the sweep under multi-objective CompositeCost (latency +
energy + price, Pareto fronts included) and a trained PredictorCost (the
GBT fitted with ``gbt_hist``, walked by ``tree_predict``), then schedules a
30-task queue over the edge cluster with cost-model-driven ETC.

Run:  PYTHONPATH=src python -m repro_torch.examples.offload_simulation \
          [--device cpu]
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import costs as co
from repro_torch.core import decisions as dec
from repro_torch.core import offload as off
from repro_torch.core import scheduler as sch
from repro_torch.core.predictors import GBTRegressor
from repro_torch.core.workloads import WorkloadConfig
from repro_torch.examples import clock, parser
from repro_torch.hw import EDGE_DEVICES, get_device

LINKS = {"2 Mb/s": 0.25e6, "20 Mb/s": 2.5e6, "200 Mb/s": 25e6,
         "2 Gb/s": 250e6}
POLICIES = ("local", "remote", "greedy", "optimal", "qlearning")
SWEEP_DEVICES = ("pi5-arm", "xps15-i5", "gtx-1650", "jetson-orin-nano")
INPUT_BYTES = 4 * 32 * 784


def workload():
    wc = WorkloadConfig("cnn", 2, epochs=5, optimiser="adam", lr=1e-3,
                        batch_size=32)
    return wc, off.workload_layer_costs(wc)


def policy_table(layers, dev) -> dict:
    """``{link: [(total_time_s, split) per policy]}``: one ``[n_links,
    L+1]`` sweep for the optimum and a table-trained Q-learning policy."""
    env_base = off.OffloadEnv(device=get_device("pi5-arm"),
                              edge=get_device("edge-server-a100"),
                              link_bw=LINKS["2 Mb/s"],
                              input_bytes=INPUT_BYTES)
    plan = dec.sweep_links(layers, env_base, list(LINKS.values()),
                           device=dev)
    pol = off.QLearningPolicy(layers, env_base, episodes=3000,
                              link_buckets=tuple(LINKS.values())).train()
    rows = {}
    for i, (name, bw) in enumerate(LINKS.items()):
        env = dataclasses.replace(env_base, link_bw=bw)
        rows[name] = [(d.total_time_s, d.split) for d in (
            off.local_only(layers, env), off.remote_only(layers, env),
            off.greedy_split(layers, env), plan[i], pol.decide(bw))]
    return rows


def dense_sweep(layers, dev) -> tuple[dict, int, float]:
    """``({device: (offload share, median latency s)}, decisions,
    seconds)`` over 1024 link states for each of four devices."""
    bw_grid = np.geomspace(1e5, 2.5e9, 1024)
    edge = get_device("edge-server-a100")
    shares, n_total = {}, 0
    t0 = clock(dev)
    for name in SWEEP_DEVICES:
        envs = dec.make_envs(get_device(name), edge, link_bw=bw_grid,
                             input_bytes=INPUT_BYTES, device=dev)
        p = dec.decide_all(layers, envs, device=dev)
        splits = p.splits.cpu().numpy()
        n_total += len(p)
        shares[name] = (float(np.mean(splits < len(layers))),
                        float(np.median(p.total_time_s.cpu().numpy())))
    return shares, n_total, clock(dev) - t0


def link_envs(dev):
    return dec.make_envs(get_device("pi5-arm"),
                         get_device("edge-server-a100"),
                         link_bw=np.geomspace(1e5, 2.5e9, 1024),
                         input_bytes=INPUT_BYTES, device=dev)


def multi_objective(layers, dev) -> tuple[dict, tuple]:
    """``({label: (mean latency, mean energy, mean price)}, (mean
    non-dominated splits, splits))``: latency-only against CompositeCost."""
    envs = link_envs(dev)
    composite = co.CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.2, "price": 1.0},
        price_per_edge_s=0.05, price_per_gb=0.02, deadline_s=0.5)
    out = {}
    for label, plan in (
            ("latency-only", dec.decide_all(layers, envs, device=dev)),
            ("composite", dec.decide_all(layers, envs, cost=composite,
                                         device=dev))):
        lat = float(np.mean(plan.total_time_s.cpu().numpy()))
        extra = None
        if plan.components is not None:
            extra = tuple(float(np.mean(plan.objective(k).cpu().numpy()))
                          for k in ("energy_j", "price"))
        out[label] = (lat, extra)
    front = composite.pareto(layers, envs).cpu().numpy()
    return out, (float(front.sum(1).mean()), front.shape[1])


def predictor_sweep(layers, dev) -> tuple[int, float, float]:
    """``(envs, seconds, split agreement)``: a GBT fitted on every edge
    device's per-layer times drives the same 1024-state grid."""
    envs = link_envs(dev)
    feats = np.concatenate([co.default_layer_features(layers, s)
                            for s in EDGE_DEVICES.values()])
    times = np.concatenate([[off.layer_time(lc.flops, s) for lc in layers]
                            for s in EDGE_DEVICES.values()])
    gbt = GBTRegressor(n_trees=60, max_depth=5).fit(feats, times,
                                                    device=dev)
    pred_cost = co.PredictorCost(gbt, get_device("pi5-arm"),
                                 get_device("edge-server-a100"))
    t0 = clock(dev)
    plan_pred = dec.decide_all(layers, envs, cost=pred_cost, device=dev)
    dt = clock(dev) - t0
    plan_true = dec.decide_all(layers, envs, device=dev)
    agree = float(np.mean(plan_pred.splits.cpu().numpy()
                          == plan_true.splits.cpu().numpy()))
    return len(envs), dt, agree


def schedule(dev) -> tuple[dict, int, int]:
    """``({scheduler: (makespan, mean completion)}, moved, tasks)``: 30
    tasks over the edge cluster, and the min_min placements that move
    under a latency+energy ETC."""
    rng = np.random.default_rng(1)
    nodes = [sch.Node(spec) for spec in EDGE_DEVICES.values()]
    tasks = [sch.Task(f"task{i}", flops=float(rng.lognormal(25, 1.0)),
                      input_bytes=float(rng.lognormal(13, 0.8)))
             for i in range(30)]
    etc = sch.etc_matrix(tasks, nodes, cost=co.AnalyticCost(), device=dev)
    out = {}
    for name, fn in sch.SCHEDULERS.items():
        s = fn(tasks, nodes, etc)
        out[name] = (s.makespan, s.mean_completion)
    etc_e = sch.etc_matrix(tasks, nodes, cost=co.CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.005}), device=dev)
    by_task = {a.task.name: a.node
               for a in sch.min_min(tasks, nodes, etc).assignments}
    by_task_e = {a.task.name: a.node
                 for a in sch.min_min(tasks, nodes, etc_e).assignments}
    moved = sum(1 for t in by_task if by_task[t] != by_task_e[t])
    return out, moved, len(tasks)


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    wc, layers = workload()
    print(f"workload: {wc.label()} — {len(layers)} layers, "
          f"{sum(l.flops for l in layers)/1e9:.2f} GFLOP/batch")

    print("\n== offloading policies across link conditions "
          "(latency ms | split point) ==")
    print(f"{'link':>10} | " + " | ".join(f"{p:>14}" for p in POLICIES))
    for name, cells in policy_table(layers, dev).items():
        print(f"{name:>10} | " + " | ".join(
            f"{f'{t*1e3:8.2f} @{s:<2}':>14}" for t, s in cells))

    print("\n== dense scenario sweep: 1024 link states × 4 devices "
          "in one batched call ==")
    shares, n_total, dt = dense_sweep(layers, dev)
    for name, (frac, med) in shares.items():
        print(f"  {name:>16}: offloads in {100*frac:5.1f}% of "
              f"link states, median latency {1e3*med:7.2f} ms")
    print(f"  [{n_total} optimal decisions in {dt*1e3:.1f} ms — "
          f"{n_total/dt:,.0f} decisions/s]")

    print("\n== multi-objective: latency-only vs energy-weighted "
          "CompositeCost (pi5 → a100) ==")
    plans, (nondom, n_splits) = multi_objective(layers, dev)
    for label, (lat, extra) in plans.items():
        tail = "" if extra is None else (
            f", mean energy {extra[0]:6.2f} J, mean price {extra[1]:7.4f}")
        print(f"  {label:>12}: mean latency {lat*1e3:8.2f} ms{tail}")
    print(f"  Pareto front: {nondom:.1f} of {n_splits} splits "
          "non-dominated per link state")

    print("\n== predictor-in-the-loop sweep: trained GBT drives the "
          "same 1024-state grid ==")
    n_envs, dt, agree = predictor_sweep(layers, dev)
    print(f"  {n_envs} predictor-driven decisions in {dt*1e3:.1f} ms "
          f"(one batched predict); split agreement with analytic "
          f"{100*agree:.1f}%")

    print("\n== scheduling 30 offloaded tasks over the edge cluster ==")
    scheds, moved, n_tasks = schedule(dev)
    for name, (makespan, mean_c) in scheds.items():
        print(f"  {name:>12}: makespan {makespan:7.2f}s  "
              f"mean-completion {mean_c:7.2f}s")
    print(f"  energy-aware min_min: {moved}/{n_tasks} tasks change node "
          f"under the latency+energy blend")


if __name__ == "__main__":
    main()
