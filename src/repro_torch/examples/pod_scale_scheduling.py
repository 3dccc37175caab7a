"""The paper's roadmap realised at datacenter scale, on the port.

The paper profiles laptop CNNs to schedule edge offloads.  Here the SAME
pipeline runs over the port's dry-run records (``python -m
repro_torch.launch.dryrun --all --out results/dryrun_torch.json``): the
compiled (architecture × input-shape) steps, priced on the H100 by
``roofline.H100_SXM``, are the profiling dataset, a GBT (``gbt_hist`` on
the card, ``tree_predict`` for its predictions) learns (arch features,
shape, hardware) → step-time, and the scheduler places the whole workload
mix across a heterogeneous fleet of H100 and A100 nodes.

Run:  PYTHONPATH=src python -m repro_torch.examples.pod_scale_scheduling \
          [--dryrun results/dryrun_torch.json] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core import scheduler as sch
from repro_torch.core.costs import AnalyticCost, CompositeCost
from repro_torch.core.predictors import GBTRegressor
from repro_torch.examples import parser
from repro_torch.hw import DeviceSpec, get_device
from repro_torch.roofline import H100_SXM

DRYRUN = os.path.join("results", "dryrun_torch.json")


def scaled(spec: DeviceSpec, n: int, name: str) -> DeviceSpec:
    """``n`` cards of ``spec`` as one node: rates, memory and TDP times
    ``n``; the link and the clock one card's."""
    return dataclasses.replace(
        spec, name=name, peak_flops=spec.peak_flops * n,
        peak_flops_f32=spec.peak_flops_f32 * n,
        hbm_bytes=spec.hbm_bytes * n, hbm_bw=spec.hbm_bw * n,
        tdp_watts=spec.tdp_watts * n)


#: the port's fleet, in cards: the dry-run prices steps on the H100
FLEET = (scaled(H100_SXM, 256, "h100-256"),
         scaled(H100_SXM, 128, "h100-128"),
         scaled(get_device("edge-server-a100"), 8, "a100-8"))


def arch_features(cfg, shape) -> list[float]:
    return [
        np.log10(max(cfg.num_layers, 1)),
        np.log10(cfg.d_model),
        cfg.num_heads, cfg.num_kv_heads,
        np.log10(max(cfg.d_ff + cfg.moe_d_ff * max(cfg.top_k, 1), 1)),
        np.log10(cfg.vocab_size),
        float(bool(cfg.num_experts)), float(cfg.attn_kind == "mla"),
        float(cfg.family in ("ssm", "hybrid")),
        np.log10(shape.seq_len), np.log10(shape.global_batch),
        {"train": 0.0, "prefill": 1.0, "decode": 2.0}[shape.mode],
    ]


def workloads(recs: list[dict]) -> tuple[np.ndarray, np.ndarray, list]:
    """``(x, log10 bound, names)`` of the dry-run's ``ok`` records."""
    x, y, names = [], [], []
    for r in recs:
        if r["status"] != "ok":
            continue
        cfg = get_config(r["arch"])
        shape = INPUT_SHAPES[r["shape"]]
        ro = r["roofline"]
        bound = max(ro["compute_s"], ro["memory_s"], ro["collective_s"])
        x.append(arch_features(cfg, shape))
        y.append(np.log10(max(bound, 1e-9)))
        names.append(f"{r['arch']}×{r['shape']}")
    return np.asarray(x, np.float32), np.asarray(y), names


def loo_errors(x, y, dev) -> list[float]:
    """Leave-one-out |log10 error| of the pod-scale profiling model."""
    errs = []
    for i in range(len(x)):
        m = GBTRegressor(n_trees=150, max_depth=4, learning_rate=0.1,
                         min_samples_leaf=1)
        mask = np.arange(len(x)) != i
        m.fit(x[mask], y[mask], device=dev)
        errs.append(abs(float(m.predict(x[i:i + 1], device=dev)[0]) - y[i]))
    return errs


def make_tasks(x, y, names, fleet, dev) -> list[sch.Task]:
    """One task a workload, its FLOPs from the model's step time on the
    fleet's first node at 35% of its f32 peak."""
    model = GBTRegressor(n_trees=200, max_depth=4, min_samples_leaf=1
                         ).fit(x, y, device=dev)
    pred = model.predict(x, device=dev).cpu().numpy()
    base = fleet[0]
    return [sch.Task(nm, flops=10 ** float(p) * base.peak_flops_f32 * 0.35)
            for nm, p in zip(names, pred)]


def schedules(tasks, fleet) -> tuple[np.ndarray, dict, dict]:
    """``(etc, {policy: (makespan, mean completion)}, {node: workloads})``
    on the analytic ETC, the last for HEFT."""
    nodes = [sch.Node(spec) for spec in fleet]
    etc = sch.etc_matrix(tasks, nodes)
    out = {}
    for name, fn in (("round_robin", sch.round_robin),
                     ("min_min", sch.min_min), ("heft", sch.heft)):
        s = fn(tasks, nodes, etc)
        out[name] = (s.makespan, s.mean_completion)
    by_node = {}
    for a in sch.heft(tasks, nodes, etc).assignments:
        by_node.setdefault(a.node, []).append(a.task.name)
    return etc, out, by_node


def energy_aware(tasks, fleet, etc, dev) -> dict:
    """``{label: (makespan in cost units, kJ)}``: min_min on the analytic
    and on a latency+energy CompositeCost ETC, energy billed at each
    node's TDP over its analytic runtime."""
    nodes = [sch.Node(spec) for spec in fleet]
    watts = {n.spec.name: n.spec.tdp_watts for n in nodes}
    idx = {t.name: i for i, t in enumerate(tasks)}
    jmap = {n.spec.name: j for j, n in enumerate(nodes)}
    out = {}
    for label, cost in (
            ("latency-only", AnalyticCost()),
            ("latency+energy", CompositeCost(
                weights={"latency_s": 1.0, "energy_j": 2e-5}))):
        etc_c = sch.etc_matrix(tasks, nodes, cost=cost, device=dev)
        s_c = sch.min_min(tasks, nodes, etc_c)
        joules = sum(etc[idx[a.task.name], jmap[a.node]] * watts[a.node]
                     for a in s_c.assignments)
        out[label] = (s_c.makespan, joules / 1e3)
    return out


def replica_sweep(tasks, fleet, etc, ks=(4, 16, 64)) -> dict:
    """``{k: (tasks, makespan, seconds)}``: the mix × k tenants through
    the vectorized min_min."""
    nodes = [sch.Node(spec) for spec in fleet]
    out = {}
    for k in ks:
        big_tasks = [sch.Task(f"{t.name}#{r}", flops=t.flops)
                     for r in range(k) for t in tasks]
        t0 = time.perf_counter()
        s = sch.min_min(big_tasks, nodes, np.tile(etc, (k, 1)))
        out[k] = (len(big_tasks), s.makespan, time.perf_counter() - t0)
    return out


def report(recs: list[dict], fleet, dev) -> None:
    """Print the reference example's lines for these dry-run records on
    ``fleet``."""
    x, y, names = workloads(recs)
    errs = loo_errors(x, y, dev)
    med = np.median(errs)
    print(f"== pod-scale profiling model: LOO median |log10 err| "
          f"{med:.3f} (≈{10**med:.2f}× time factor) over {len(x)} "
          "workloads")

    tasks = make_tasks(x, y, names, fleet, dev)
    etc, scheds, by_node = schedules(tasks, fleet)
    for name, (makespan, mean_c) in scheds.items():
        print(f"  {name:>12}: makespan {makespan:8.3f}s, "
              f"mean completion {mean_c:7.3f}s")
    for node, lst in by_node.items():
        print(f"  {node}: {len(lst)} workloads "
              f"(e.g. {', '.join(lst[:3])}...)")

    print("\n== energy-aware placement (CompositeCost ETC) ==")
    for label, (makespan, kj) in energy_aware(tasks, fleet, etc,
                                              dev).items():
        print(f"  {label:>15}: makespan(cost) {makespan:8.3f}, "
              f"energy {kj:8.1f} kJ")

    print("\n== replica sweep: the workload mix × K tenants, "
          "vectorized min_min ==")
    for k, (n, makespan, dt) in replica_sweep(tasks, fleet, etc).items():
        print(f"  ×{k:>3} ({n:>5} tasks): makespan "
              f"{makespan:9.3f}s, scheduled in {dt*1e3:7.1f} ms")


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--dryrun", default=DRYRUN,
                    help="the dry-run's JSON records")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if not os.path.exists(args.dryrun):
        print(f"run the dry-run first: {args.dryrun} missing")
        return
    with open(args.dryrun) as f:
        recs = json.load(f)
    report(recs, FLEET, dev)


if __name__ == "__main__":
    main()
