"""Trace analytics, on the port: attribution, miss causes, diff, live
tails.

A deliberately saturated run — bursty MMPP arrivals into capacity-1
node pools with a heavy-tailed RTT and tight deadlines — is traced and
then pushed through the ``repro_torch.obs.analyze`` consumption layer:

  * **attribution** — per-run phase attribution reconstructed from the
    spans alone (``sojourn = queue_wait + service + transfer``), checked
    float-exact against ``Telemetry.summary()``;
  * **miss attribution** — each deadline miss classified by its most
    inflated phase, corroborated against control-plane instants;
  * **differential profiling** — ``diff(event, fleet)`` on identical
    seeds must be all-zero (the engines are bit-for-bit equal; the fleet
    engine's singleton runs go through ``fleet_scan``), while ``diff``
    against a degraded-RTT rerun localises the regression to the
    transfer phase;
  * **streaming quantiles** — a mergeable ``QuantileSketch`` follows the
    live sojourn tail to within 2% of exact at 128 centroids;
  * **regression gating** — ``regress --selftest`` on the committed
    ``BENCH_7.json`` baseline (``--baseline``; by default the one in the
    working directory, the repository's root).

Run:  PYTHONPATH=src python -m repro_torch.examples.trace_analytics \
          [--device cpu] [--baseline BENCH_7.json]
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch._device import resolve_device
from repro_torch import sim
from repro_torch.core import scheduler as sch
from repro_torch.examples import parser, require
from repro_torch.hw import EDGE_DEVICES
from repro_torch.obs import Tracer
from repro_torch.obs.analyze import (QuantileSketch, attribute, diff,
                                     load_rows, selftest)

SPECS = list(EDGE_DEVICES.values())


def saturating_run(dev, engine="event", *, rtt_scale=0.02):
    """One traced MMPP burst into capacity-1 pools -> (tel, tracer)."""
    n_nodes = 3
    arrivals = sim.mmpp_arrivals([40.0, 400.0], [0.5, 0.2],
                                 horizon=2.0, seed=11)
    rng = np.random.default_rng(11)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 2e11)),
                      input_bytes=float(rng.uniform(1e4, 1e6)),
                      deadline_s=float(arrivals[i]
                                       + rng.uniform(0.005, 0.3)))
             for i in range(len(arrivals))]
    nodes = [sch.Node(SPECS[j % len(SPECS)]) for j in range(n_nodes)]
    tracer = Tracer()
    tel = sim.simulate_stream(
        tasks, arrivals, nodes, policy="min_min",
        pools=sim.NodePools.uniform(n_nodes, 1),
        rtt=sim.WeibullRTT(shape=0.6, scale=rtt_scale, seed=13),
        engine=engine, obs=tracer, device=dev)
    return tel, tracer


def attribution(dev):
    """``(run, telemetry summary, tracer)``: the attribution of the event
    run, its aggregates held float-exact to ``Telemetry.summary()``."""
    tel, tracer = saturating_run(dev, "event")
    run = attribute(tracer)
    s_span, s_tel = run.summary(), tel.summary()
    for k in ("p50_completion_s", "p99_completion_s", "mean_wait_s",
              "deadline_misses", "miss_rate"):
        require(s_span[k] == s_tel[k], (k, s_span[k], s_tel[k]))
    return run, s_tel, tracer


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument("--baseline", default="BENCH_7.json",
                    help="the regression gate's committed baseline")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    baseline = Path(args.baseline)
    if not baseline.is_file():
        raise SystemExit(f"trace_analytics: no baseline at {baseline}: run "
                         "from the repository's root or pass --baseline")
    run, s_tel, tracer = attribution(dev)

    print("== phase attribution (from spans alone) ==")
    print(run.table_str())
    print("\n[ok] span-derived aggregates are float-exact equal to "
          "Telemetry.summary()")

    ma = run.miss_attribution()
    print(f"\n== miss attribution: {ma['n_misses']}/{ma['n_tasks']} "
          f"tasks missed ==")
    for cause, n in sorted(ma["by_cause"].items(), key=lambda kv: -kv[1]):
        print(f"  {cause:>24}: {n}")
    worst = max(ma["misses"], key=lambda m: m["excess_s"])
    print(f"  worst: {worst['task']} ({worst['cause']}, "
          f"{1e3 * worst['excess_s']:.1f} ms over deadline, dominant "
          f"phase {worst['dominant_phase']})")
    require(ma["n_misses"] == s_tel["deadline_misses"],
            "miss attribution and telemetry count different misses")
    require(ma["by_cause"]["pool_contention"] >= 1,
            "no miss attributed to pool contention")

    # same seeds on the fleet engine: bit-for-bit equal -> diff is zero
    _, tracer_fleet = saturating_run(dev, "fleet")
    d0 = diff(tracer, tracer_fleet)
    print("\n== diff: event vs fleet engine, identical seeds ==")
    print(d0.table_str())
    require(d0.is_zero, "engines diverged on identical seeds")

    # a degraded link (4x RTT scale): the regression localises to the
    # transfer phase, and the K-S statistic flags the shifted tail
    _, tracer_slow = saturating_run(dev, "event", rtt_scale=0.08)
    d1 = diff(tracer, tracer_slow, top_k=3)
    print("\n== diff: baseline vs 4x RTT scale ==")
    print(d1.table_str())
    require(not d1.is_zero, "a 4x RTT scale left the diff zero")
    require(d1.phases["transfer"].mean_delta > 0.0,
            "the transfer phase did not slow down")
    require(d1.phases["transfer"].ks > d1.phases["service"].ks,
            "the K-S statistic did not single out the transfer phase")
    print("\n[ok] regression localised to the transfer phase "
          f"(Δmean {1e3 * d1.phases['transfer'].mean_delta:+.2f} ms, "
          f"KS {d1.phases['transfer'].ks:.3f})")

    soj = run.tasks.sojourn_s
    sk = QuantileSketch()
    for chunk in np.array_split(soj, 7):     # streamed, not batched
        sk.observe_many(chunk)
    exact = float(np.percentile(soj, 99))
    est = sk.quantile(0.99)
    rel = abs(est - exact) / exact
    print(f"\n== live tail: QuantileSketch over {sk.count} sojourns ==")
    print(f"  p50 {1e3 * sk.quantile(0.5):.2f} ms   "
          f"p99 {1e3 * est:.2f} ms (exact {1e3 * exact:.2f} ms, "
          f"rel err {100 * rel:.2f}%)")
    require(rel <= 0.02, f"sketch p99 off by {rel:.4f} relative")

    ok, text = selftest(load_rows(str(baseline)))
    print(f"\n== regress selftest on {baseline.name} ==")
    print(text)
    require(ok, "regression-gate selftest failed")


if __name__ == "__main__":
    main()
