"""Streaming offload under drifting 6G conditions, on the port.

A diurnal arrival wave of CNN inference tasks hits a heterogeneous edge
cluster while every uplink drifts: the cluster's per-node links follow
seeded random walks, and the user device's link to the edge server is a
Gilbert–Elliott good/bad channel.  The run shows the three
``repro_torch.sim`` seams working together:

  * incremental online placement — :class:`repro_torch.sim.StreamScheduler`
    re-plans on the live ``[T, N]`` finish matrix per arrival, with tail
    migration onto freed nodes;
  * Pareto-aware split planning — :class:`repro_torch.sim.
    ParetoStreamScheduler` keeps each live task's (latency, energy,
    price) front alive on the torch device and re-picks as the channel
    flips, vs the commit-at-admission scalarised policy;
  * telemetry — p50/p99 completion, deadline misses, energy, node
    utilisation and re-plan counters in the ``results/`` record schema;
  * observability — a :class:`repro_torch.obs.Tracer` rides along and
    exports the run as ``results/trace.json`` under the working directory
    (Chrome trace-event JSON, for https://ui.perfetto.dev).

Run:  PYTHONPATH=src python -m repro_torch.examples.streaming_offload \
          [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch._device import resolve_device
from repro_torch import sim
from repro_torch.core import offload as off
from repro_torch.core import scheduler as sch
from repro_torch.core.workloads import WorkloadConfig
from repro_torch.examples import parser, require
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.obs import Tracer, validate_chrome

TRACE_PATH = os.path.join("results", "trace.json")


def stream():
    """``(layers, arrivals, tasks)``: a diurnal wave of brokered tasks."""
    wc = WorkloadConfig("cnn", 2, epochs=5, optimiser="adam", lr=1e-3,
                        batch_size=32)
    layers = off.workload_layer_costs(wc)
    arrivals = sim.diurnal_arrivals(14.0, horizon=20.0, amplitude=0.9,
                                    period_s=8.0, seed=1)
    rng = np.random.default_rng(0)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(5e10, 8e11)),
                      input_bytes=float(rng.uniform(1e5, 5e6)),
                      deadline_s=float(a + rng.uniform(0.5, 6.0)))
             for i, a in enumerate(arrivals)]
    return layers, arrivals, tasks


def run(layers, arrivals, tasks, dev):
    """``(telemetry, planner, completions, tracer)``: the stream with the
    Pareto planner re-picking splits along the placements."""
    nodes = [sch.Node(spec) for spec in EDGE_DEVICES.values()]
    links = sim.ClusterLinks.random_walk(
        [n.spec.link_bw for n in nodes], sigma=0.6, seed=2)
    split_env = sim.DriftingEnv(
        device=get_device("pi5-arm"), edge=get_device("edge-server-a100"),
        link=sim.TwoStateLink(1.25e9, 2e5, mean_good_s=1.5,
                              mean_bad_s=1.5, seed=3),
        input_bytes=1e5)
    planner = sim.ParetoStreamScheduler(device=split_env.device,
                                        edge=split_env.edge,
                                        torch_device=dev)
    completions = []
    orig_complete = planner.complete

    def complete_and_keep(rid, link_bw, *, now=0.0):
        rec = orig_complete(rid, link_bw, now=now)
        completions.append(rec)
        return rec

    planner.complete = complete_and_keep
    tracer = Tracer()
    tel = sim.simulate_stream(tasks, arrivals, nodes, policy="min_min",
                              links=links, link_update_dt=0.25,
                              split_planner=planner, split_env=split_env,
                              split_layers=layers, rebalance=True,
                              obs=tracer, device=dev)
    return tel, planner, completions, tracer


def repick_vs_commit(planner, completions, n_layers) -> dict:
    """Realised latency and energy of the live (re-picked) splits against
    the admission-time picks, under the final link state; raises where the
    example's pins fail."""
    names = tuple(planner.cost.objectives)

    def realised(key, obj):
        return np.asarray([c[key][obj] for c in completions])

    out = {"switched": sum(1 for c in completions if c["switches"] > 0),
           "latency": (realised("realised", "latency_s").mean(),
                       realised("realised_at_admission_pick",
                                "latency_s").mean()),
           "energy": (realised("realised", "energy_j").mean(),
                      realised("realised_at_admission_pick",
                               "energy_j").mean())}
    # the drifting channel must actually move picks, and every final pick
    # must be non-dominated on the final front
    require(planner.total_switches >= 1,
            "drifting link produced no split switches")
    require(all(c["switches"] >= 0 and 0 <= c["pick"] <= n_layers
                for c in completions), "a pick out of range")
    require("latency_s" in names, "no latency objective")
    # re-picking can only help the scalarised cost it optimises
    w = {n: 1.0 for n in names} if planner.cost.weights is None \
        else dict(planner.cost.weights)
    re_cost = sum(w.get(n, 0.0) * realised("realised", n) for n in names)
    ad_cost = sum(w.get(n, 0.0) * realised("realised_at_admission_pick", n)
                  for n in names)
    require(re_cost.mean() <= ad_cost.mean() + 1e-12,
            "re-picking raised the scalarised cost")
    return out


def main(argv=None) -> None:
    dev = resolve_device(parser(__doc__).parse_args(argv).device)
    layers, arrivals, tasks = stream()
    print(f"stream: {len(tasks)} tasks over {arrivals.max():.1f}s "
          f"(diurnal wave, period 8s, amplitude 0.9)")
    tel, planner, completions, tracer = run(layers, arrivals, tasks, dev)

    print("\n== run telemetry (results/-schema record) ==")
    print(tel.table())

    print("\n== node utilisation ==")
    for node, u in tel.utilisation().items():
        print(f"  {node:>18}: {100 * u:5.1f}%")

    r = repick_vs_commit(planner, completions, len(layers))
    print("\n== Pareto re-pick along the live front vs scalarised "
          "commit-at-admission ==")
    print(f"  tasks that switched splits: {r['switched']}/"
          f"{len(completions)} ({planner.total_switches} switches over "
          f"{planner.total_repicks} re-picks)")
    print(f"  mean realised latency: {1e3 * r['latency'][0]:8.2f} ms "
          f"(re-picked)  vs {1e3 * r['latency'][1]:8.2f} ms (committed)")
    print(f"  mean realised energy:  {r['energy'][0]:8.2f} J  "
          f"(re-picked)  vs {r['energy'][1]:8.2f} J  (committed)")
    print("\n[ok] splits switched under drift and every pick stayed on "
          "the live Pareto front")

    stats = validate_chrome(tracer.export_chrome(TRACE_PATH))
    print(f"\n== trace ==\n  wrote {TRACE_PATH}: "
          f"{stats['n_spans']} spans + {stats['n_instants']} instants "
          f"on {stats['n_tracks']} tracks — open in "
          f"https://ui.perfetto.dev")


if __name__ == "__main__":
    main()
