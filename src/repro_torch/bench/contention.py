"""Edge-contention benchmark of the port: server pools, heavy tails,
tail-aware wins, the counterpart of ``benchmarks/bench_contention.py``.

Three curves over ``repro_torch.sim.queueing`` (host code in the port as
in the reference: CPU rows only):

  * ``throughput-vs-rho`` — ServerPool admission throughput and the
    simulated mean sojourn against the M/M/c closed form at rho in
    {0.3, 0.7, 0.9};
  * ``p99-vs-capacity`` — p99 sojourn as the pool grows servers at fixed
    offered load (more servers must cut the tail);
  * ``incremental wait`` — ``NodePools``'s O(c) per-admit ``avail``
    maintenance against the O(N*c) recompute (must not be slower).

And the tail-vs-mean scenario: a saturating MMPP burst against one edge
pool with a Weibull RTT, each arrival's split decided mean-only
(``CompositeCost``) or tail-aware (``tail="p99"`` / ``"cvar"``) through
``QueueAwareCost`` with the live pool wait, the same RTT draws replayed
for every policy.  It runs on each path: the CPU's and the card's exact
``torch`` sweeps (the reference's ``numpy`` backend) and the
``decide_split`` kernel at E = 1 (``_card`` / ``_kernel`` rows).  Full
runs assert tail-aware misses below mean-only and the queueing rows'
relative error below 0.15.  :func:`tail_scenario` builds the scenario,
which ``chip_smoke.py`` runs at its full horizon.

Run:  PYTHONPATH=src python -m repro_torch.bench.contention \\
          [--device cpu] [--smoke]

Rows go to ``results/bench_torch_contention.json``.
"""
from __future__ import annotations

import time
import types

import numpy as np
import torch

from repro_torch.bench.common import (counting, emit, parser, paths,
                                      require, tag)
from repro_torch.core import costs as co
from repro_torch.core import decisions as dec
from repro_torch.core.offload import LayerCost
from repro_torch.hw import get_device
from repro_torch.sim import (NodePools, ServerPool, WeibullRTT, mm1_sojourn,
                             mmc_sojourn, mmpp_arrivals, spawn_streams)

TIMED = ("admissions_per_sec", "us_per_call", "speedup_vs_recompute",
         "us_per_decision")


# --------------------------------------------------------------------------
# throughput vs offered load
# --------------------------------------------------------------------------
def bench_throughput_vs_rho(n: int, c: int = 2) -> list[dict]:
    rows = []
    for rho in (0.3, 0.7, 0.9):
        mu = 1.0
        lam = rho * c * mu
        arr_ss, svc_ss = spawn_streams(0, 2)
        arr = np.cumsum(np.random.default_rng(arr_ss)
                        .exponential(1.0 / lam, n))
        svc = np.random.default_rng(svc_ss).exponential(1.0 / mu, n)
        pool = ServerPool(c)
        t0 = time.perf_counter()
        soj = np.empty(n)
        for i in range(n):
            _, fin = pool.admit(arr[i], svc[i])
            soj[i] = fin - arr[i]
        dt = time.perf_counter() - t0
        want = mm1_sojourn(lam, mu) if c == 1 else mmc_sojourn(lam, mu, c)
        rows.append(tag({
            "name": f"contention_rho{rho}_c{c}",
            "rho": rho, "capacity": c, "n_admissions": n,
            "admissions_per_sec": n / dt,
            "mean_sojourn_s": float(soj.mean()),
            "erlang_c_sojourn_s": want,
            "rel_err": abs(float(soj.mean()) / want - 1.0),
        }, "cpu"))
    return rows


# --------------------------------------------------------------------------
# p99 sojourn vs pool capacity at fixed total offered load
# --------------------------------------------------------------------------
def bench_p99_vs_capacity(n: int) -> list[dict]:
    rows = []
    lam, mu = 3.6, 1.0                   # offered load a = 3.6 erlangs
    for c in (4, 6, 8, 12):
        arr_ss, svc_ss = spawn_streams(1, 2)
        arr = np.cumsum(np.random.default_rng(arr_ss)
                        .exponential(1.0 / lam, n))
        svc = np.random.default_rng(svc_ss).exponential(1.0 / mu, n)
        pool = ServerPool(c)
        soj = np.empty(n)
        for i in range(n):
            _, fin = pool.admit(arr[i], svc[i])
            soj[i] = fin - arr[i]
        rows.append(tag({
            "name": f"contention_p99_c{c}",
            "capacity": c, "offered_load": lam / mu,
            "p99_sojourn_s": float(np.percentile(soj, 99)),
            "mean_sojourn_s": float(soj.mean()),
        }, "cpu"))
    # more servers must cut the tail
    require(rows[-1]["p99_sojourn_s"] < rows[0]["p99_sojourn_s"],
            "more servers did not cut the p99 sojourn")
    return rows


# --------------------------------------------------------------------------
# incremental avail maintenance vs full recompute (the gate)
# --------------------------------------------------------------------------
def bench_incremental_wait(n_admits: int, n_nodes: int = 64,
                           c: int = 4) -> list[dict]:
    rng = np.random.default_rng(2)
    js = rng.integers(0, n_nodes, n_admits)
    ts = np.cumsum(rng.exponential(0.01, n_admits))
    svcs = rng.exponential(1.0, n_admits)

    pools = NodePools.uniform(n_nodes, c)
    t0 = time.perf_counter()
    for k in range(n_admits):            # O(c) incremental per admit
        pools.admit(int(js[k]), float(ts[k]), float(svcs[k]))
    t_inc = time.perf_counter() - t0

    pools2 = NodePools.uniform(n_nodes, c)
    t0 = time.perf_counter()
    for k in range(n_admits):            # O(N*c) recompute per admit
        pools2.pools[int(js[k])].admit(float(ts[k]), float(svcs[k]))
        pools2.avail = pools2.recompute_avail()
    t_rec = time.perf_counter() - t0
    require(np.array_equal(pools.avail, pools2.avail),
            "incremental avail differs from the recompute")
    speedup = t_rec / t_inc
    require(speedup >= 1.0, (
        f"incremental avail maintenance slower than full recompute: "
        f"{t_inc*1e3:.1f}ms vs {t_rec*1e3:.1f}ms over {n_admits} admits"))
    return [tag({
        "name": f"contention_incremental_n{n_nodes}_c{c}",
        "n_nodes": n_nodes, "capacity": c, "n_admissions": n_admits,
        "us_per_call": t_inc / n_admits * 1e6,
        "speedup_vs_recompute": speedup,
    }, "cpu")]


# --------------------------------------------------------------------------
# tail-aware vs mean-only under a saturating MMPP burst
# --------------------------------------------------------------------------
def _mk_layers(n: int = 8) -> list[LayerCost]:
    # ~2.6e11 FLOPs total: ~0.30 s on the Jetson, ~0.04 s on the A100 —
    # offloading looks great in expectation and terrible at the RTT p99
    rng = np.random.default_rng(3)
    return [LayerCost(f"l{i}", flops=float(rng.uniform(2e10, 4.5e10)),
                      act_bytes=float(rng.uniform(2e5, 4e6)))
            for i in range(n)]


def tail_scenario(horizon: float) -> types.SimpleNamespace:
    """The scenario's device, edge, layers, MMPP arrivals, replayed RTT
    samples, RTT model and input size."""
    arr_ss, rtt_ss = spawn_streams(4, 2)
    arr = mmpp_arrivals([2.0, 40.0], [8.0, 3.0], horizon=horizon,
                        seed=arr_ss)
    return types.SimpleNamespace(
        device=get_device("jetson-orin-nano"),
        edge=get_device("edge-server-a100"), layers=_mk_layers(), arr=arr,
        rtt_samples=WeibullRTT(shape=0.6, scale=0.02,
                               seed=rtt_ss).sample(len(arr)),
        rtt_model=WeibullRTT(shape=0.6, scale=0.02, seed=0),
        input_bytes=2e6)


def policy_cost(sc, tail, pool) -> co.QueueAwareCost:
    """Mean-only minimises expected completion; tail-aware the predicted
    p99/CVaR completion (latency + tail RTT excess); both see ``pool``'s
    live wait."""
    base = co.CompositeCost(
        weights={"latency_s": 1.0} if tail is None else
        {"tail_latency_s": 1.0},
        tail=tail, rtt=None if tail is None else sc.rtt_model,
        tail_alpha=0.99)
    return co.QueueAwareCost(base=base, edge_pool=pool, rtt=sc.rtt_model)


def bench_tail_vs_mean(horizon: float, deadline_s: float = 0.35,
                       capacity: int = 2, path: str = "cpu",
                       dev="cpu") -> list[dict]:
    """Replay one MMPP-burst arrival trace under three split policies
    (mean-only / p99 / CVaR) on one path, charging every offloaded task
    the live edge-pool wait and the SAME heavy-tailed RTT draw, and count
    deadline misses."""
    sc = tail_scenario(horizon)
    n = len(sc.arr)
    backend = "kernel" if path == "kernel" else "torch"
    envs = dec.make_envs(sc.device, sc.edge, link_bw=np.asarray([30e6]),
                         link_latency_s=0.005,
                         input_bytes=np.asarray([sc.input_bytes]),
                         device=dev)

    def run(tail: str | None) -> dict:
        pool = ServerPool(capacity)
        cost = policy_cost(sc, tail, pool)
        misses, lat_sum, offloads, dec_s = 0, 0.0, 0, 0.0
        for i in range(n):
            t = float(sc.arr[i])
            cost.set_now(t)
            t0 = time.perf_counter()
            plan = dec.decide_all(sc.layers, envs, cost=cost,
                                  backend=backend, device=dev)
            s, dev_t, edge_t, xfer_t = torch.stack([
                plan.splits.double(), plan.device_time_s, plan.edge_time_s,
                plan.transfer_time_s]).cpu()[:, 0].tolist()
            dec_s += time.perf_counter() - t0
            if edge_t > 0.0:             # offloading: queue + tail RTT
                offloads += 1
                xfer = xfer_t - cost._edge_wait() \
                    + float(sc.rtt_samples[i])
                _, fin = pool.admit(t + dev_t + xfer, edge_t)
                realised = fin - t
            else:                        # fully on-device
                realised = dev_t
            lat_sum += realised
            if realised > deadline_s:
                misses += 1
        return {"misses": misses, "mean_latency_s": lat_sum / n,
                "offload_frac": offloads / n,
                "us_per_decision": 1e6 * dec_s / max(n, 1)}

    # one sweep first, outside the timing: it builds the kernel
    dec.decide_all(sc.layers, envs, cost=policy_cost(sc, None,
                                                     ServerPool(capacity)),
                   backend=backend, device=dev)
    rows = []
    suffix = "" if path == "cpu" else f"_{path}"
    results = {}
    for tail in ("mean", "p99", "cvar"):
        with counting() as launched:
            results[tail] = run(None if tail == "mean" else tail)
        res = results[tail]
        rows.append(tag({
            "name": f"contention_mmpp_{tail}{suffix}",
            "policy": tail, "n_tasks": n, "deadline_s": deadline_s,
            "capacity": capacity,
            "deadline_misses": res["misses"],
            "miss_rate": res["misses"] / max(n, 1),
            "mean_latency_s": res["mean_latency_s"],
            "offload_frac": res["offload_frac"],
            "us_per_decision": res["us_per_decision"],
        }, path, launched, ("decide_split",)))
    for r in rows[1:]:
        r["miss_reduction_vs_mean"] = (
            results["mean"]["misses"] - r["deadline_misses"]) \
            / max(results["mean"]["misses"], 1)
    return rows


def main(smoke: bool = False, device=None) -> list[dict]:
    runs = paths(device)
    if smoke:
        n_queue, n_admits, horizon = 5_000, 5_000, 30.0
    else:
        n_queue, n_admits, horizon = 40_000, 40_000, 240.0
    rows: list[dict] = []
    rows += bench_throughput_vs_rho(n_queue)
    rows += bench_p99_vs_capacity(n_queue)
    rows += bench_incremental_wait(n_admits)
    for path, dev in runs:
        tail_rows = bench_tail_vs_mean(horizon, path=path, dev=dev)
        rows += tail_rows
        if not smoke:
            # tail-aware decisions measurably cut misses under the burst
            mean_misses = tail_rows[0]["deadline_misses"]
            for r in tail_rows[1:]:
                require(r["deadline_misses"] < mean_misses, (
                    f"{r['name']}: misses {r['deadline_misses']} not "
                    f"below mean-only {mean_misses}"))
    if not smoke:
        # queueing validation held at benchmark scale too
        for r in rows:
            if "rel_err" in r:
                require(r["rel_err"] < 0.15, f"{r}")
    emit(rows, "contention")
    return rows


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(smoke=args.smoke, device=args.device)
