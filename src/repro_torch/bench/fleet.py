"""Fleet-engine benchmark of the port: the time-slabbed array engine
against the event loop, the counterpart of ``benchmarks/bench_fleet.py``.

Sweeps fleet size (and with it offered load) through one simulated
diurnal "day" (diurnal arrival intensity over a 3,600 s horizon, per-node
diurnal link tides stepped every virtual second) and runs the identical
configuration through both engines:

  * ``host``  — ``simulate_stream(engine="event")`` on the CPU: the event
                loop, one heap pop per arrival / finish / link tick;
  * ``fleet`` — ``simulate_stream(engine="fleet")``: batched arrival
                slabs, singleton runs placed by ``fleet_scan``; on the CPU
                its plain version (``plain: true``), on the card the kernel
                (``fleet_fleet_..._kernel`` rows, with their launches, one
                per singleton run the engine hands it; ``scan_steps``
                counts the runs' steps, and a cell with no run long enough
                for the scan, all host code, runs on the card unlaunched).

Events = arrivals + arrival batches + link ticks processed.  Gates, on
the invocation's own fleet path (the card's kernel path; the CPU's when
only the CPU runs, as the reference's gates skip its interpret-mode
rows): at the largest cell the fleet run no slower than the host loop, on
full runs at least 20x faster; a traced fleet run
(``repro_torch.obs.Tracer``) within 10% of the untraced one, its Chrome
export well paired (``obs_gate``; the export, where the tracer's deferred
columns become events, timed apart as ``export_ms``).  These three time gates fail after
the rows are written (``bench.common.GateBroken``), so that their numbers
are kept.  The event loop has no tensor path (its analytic ETC is
host code), so its rows are the CPU's only.  :func:`fleet_day` is the
cell itself, which ``chip_smoke.py`` runs on card and CPU.

Run:  PYTHONPATH=src python -m repro_torch.bench.fleet [--device cpu] \\
          [--smoke | --gate-spread N]

``--gate-spread N`` prints N independent readings of the smoke cell's
tracing gate (:func:`gate_spread`) and writes no rows.

Rows go to ``results/bench_torch_fleet.json``.
"""
from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch

from repro_torch.bench.common import (GateBroken, counting, emit, parser,
                                      paths, require, tag)
from repro_torch.bench.stream import make_cluster, make_tasks
from repro_torch.sim import (ClusterLinks, DiurnalLink, diurnal_arrivals,
                             simulate_stream)

HORIZON_S = 3600.0                       # one simulated diurnal "day"
LINK_DT = 1.0
#: the smoke mode's horizon and (tasks, nodes) cells, the reference's
SMOKE_HORIZON_S, SMOKE_CELLS = 120.0, [(500, 8), (1500, 16)]
TIMED = ("events_per_sec", "total_ms", "speedup_vs_host", "untraced_ms",
         "trace_overhead", "export_ms")


def make_links(n_nodes: int, horizon: float) -> ClusterLinks:
    return ClusterLinks([DiurnalLink(4e7, amplitude=0.5,
                                     period_s=horizon / 2,
                                     noise_sigma=0.1, seed=2 + j)
                         for j in range(n_nodes)])


def fleet_day(n_tasks: int, n_nodes: int,
              horizon: float = HORIZON_S) -> tuple:
    """One cell: (tasks, arrivals, nodes, a factory of fresh links)."""
    arr = diurnal_arrivals(n_tasks / horizon * 1.2, horizon=horizon,
                           amplitude=0.6, period_s=horizon / 2,
                           seed=1)[:n_tasks]
    return (make_tasks(len(arr), seed=0), arr, make_cluster(n_nodes),
            lambda: make_links(n_nodes, horizon))


@contextlib.contextmanager
def scan_runs():
    """Yields a list that collects the length of every singleton run the
    fleet engine hands to ``fleet_scan`` inside the block (its plain
    version on the CPU, the kernel on the card): runs shorter than the
    engine's threshold stay in host code."""
    from repro_torch.kernels.fleet_scan import ops
    real, seen = ops.place_singletons, []

    def counted(avail, *args):
        seen.append(int(args[2].numel()))
        return real(avail, *args)

    ops.place_singletons = counted
    try:
        yield seen
    finally:
        ops.place_singletons = real


def run_engine(engine: str, n_tasks: int, n_nodes: int, horizon: float,
               obs=None, device="cpu") -> tuple[float, int]:
    """(wall seconds, events processed) for one engine pass on
    ``device``."""
    tasks, arr, nodes, links = fleet_day(n_tasks, n_nodes, horizon)
    links = links()
    t0 = time.perf_counter()
    tel = simulate_stream(tasks, arr, nodes, policy="min_min",
                          links=links, link_update_dt=LINK_DT,
                          engine=engine, obs=obs, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(len(tel.records) == len(arr),
            f"{len(tel.records)} records of {len(arr)} tasks")
    # finish pops + arrival-batch pops + link-tick pops (the host loop's
    # heap traffic; link_refreshes counts per-node updates, one tick
    # touches every drifting node)
    events = len(arr) + tel.counters.get("replans", 0) \
        + int(tel.counters.get("link_refreshes", 0) / max(n_nodes, 1))
    return dt, events


def obs_gate(n_tasks: int, n_nodes: int, horizon: float,
             t_untraced: float, reps: int, path: str = "cpu",
             device="cpu") -> tuple[dict, str | None]:
    """A traced fleet run within 10% of the untraced wall clock (min of
    reps on both sides, the two runs of a rep back to back, so that a
    change of the host's load between them weighs on both alike), and its
    Chrome export passing the span-pairing checker.  Returns the row and,
    where the time gate fails, its message (the export's checks raise at
    once)."""
    from repro_torch.obs import Tracer, validate_chrome
    with counting() as launched:
        t_plain, t_traced, tracer = t_untraced, np.inf, None
        for _ in range(reps):
            t_plain = min(t_plain, run_engine("fleet", n_tasks, n_nodes,
                                              horizon, device=device)[0])
            tr = Tracer()
            dt = run_engine("fleet", n_tasks, n_nodes, horizon, obs=tr,
                            device=device)[0]
            if dt < t_traced:
                t_traced, tracer = dt, tr
    broken = None if t_traced <= 1.10 * t_plain else (
        f"tracing overhead {t_traced / t_plain - 1.0:+.1%} > 10% at "
        f"tasks={n_tasks}, n_nodes={n_nodes} on {path} "
        f"({t_traced*1e3:.1f}ms traced vs {t_plain*1e3:.1f}ms untraced)")
    # the tracer's deferred work (its columns made into events) runs here,
    # outside the timed run: ``export_ms`` keeps it visible
    t0 = time.perf_counter()
    trace = tracer.export_chrome(None)
    export_s = time.perf_counter() - t0
    stats = validate_chrome(trace)
    # every task contributes at least its sojourn + service pair
    require(stats["n_spans"] >= 2 * n_tasks, f"{stats}")
    return tag({
        "name": f"fleet_traced_t{n_tasks}_n{n_nodes}"
                + ("" if path == "cpu" else f"_{path}"),
        "engine": "fleet+obs",
        "n_tasks": n_tasks,
        "n_nodes": n_nodes,
        "total_ms": t_traced * 1e3,
        "untraced_ms": t_plain * 1e3,
        "trace_overhead": t_traced / t_plain - 1.0,
        "export_ms": export_s * 1e3,
        **stats,
    }, path, launched, ("fleet_scan",)), broken


def fleet_rows(cells, horizon: float, reps: int, runs,
               full: bool) -> list[dict]:
    """Both engines per cell: the event loop on the CPU, the fleet engine
    on each path of ``runs`` except the card's plain one (the fleet
    engine's scan on the card is the kernel)."""
    fleets = [(p, d) for p, d in runs if p != "card"]
    # build and warm each fleet path outside the timed region
    for path, dev in fleets:
        for n_nodes in sorted({n for _, n in cells}):
            run_engine("fleet", 600, n_nodes, horizon, device=dev)
    rows: list[dict] = []
    broken: list[str] = []
    for n_tasks, n_nodes in cells:
        t_host = min(run_engine("event", n_tasks, n_nodes, horizon)[0]
                     for _ in range(reps))
        done = []
        for path, dev in fleets:
            with counting() as launched, scan_runs() as runs_seen:
                t_fleet, events = min(
                    run_engine("fleet", n_tasks, n_nodes, horizon,
                               device=dev) for _ in range(reps))
            speedup = t_host / t_fleet
            # the kernel's path where the engine had a run for it, each
            # run one launch
            scan_path = path
            if path == "kernel":
                require(launched.get("fleet_scan", 0) == len(runs_seen), (
                    f"fleet {n_tasks}x{n_nodes}: {len(runs_seen)} scan runs "
                    f"but {launched.get('fleet_scan', 0)} fleet_scan "
                    "launches"))
                scan_path = "kernel" if runs_seen else "card"
            for name, dt in (("host", t_host), ("fleet", t_fleet)):
                if name == "host" and path != "cpu":
                    continue
                rows.append({
                    "name": f"fleet_{name}_t{n_tasks}_n{n_nodes}"
                            + ("" if path == "cpu" else f"_{path}"),
                    "engine": name,
                    "n_tasks": n_tasks,
                    "n_nodes": n_nodes,
                    "horizon_s": horizon,
                    "events": events,
                    "events_per_sec": events / dt,
                    "total_ms": dt * 1e3,
                })
                if name == "fleet":
                    rows[-1]["scan_steps"] = sum(runs_seen) // reps
                tag(rows[-1], scan_path if name == "fleet" else "cpu",
                    launched, ("fleet_scan",))
            rows[-1]["speedup_vs_host"] = speedup
            if (n_tasks, n_nodes) == cells[-1] and (path, dev) == fleets[-1]:
                # the gates, on the invocation's own fleet path: the array
                # engine must not lose to the heap
                if t_fleet > t_host:
                    broken.append(
                        f"fleet engine ({path}) slower than the host event "
                        f"loop at the largest config (tasks={n_tasks}, "
                        f"n_nodes={n_nodes}): {t_fleet*1e3:.1f}ms vs "
                        f"{t_host*1e3:.1f}ms")
                if full and speedup < 20.0:  # full-run acceptance bar
                    broken.append(
                        f"fleet speedup ({path}) {speedup:.1f}x < 20x at "
                        f"the largest config (tasks={n_tasks}, "
                        f"n_nodes={n_nodes})")
                row, gate = obs_gate(n_tasks, n_nodes, horizon, t_fleet,
                                     max(reps, 3), path, dev)
                done.append(row)
                broken += [gate] if gate else []
        rows += done
    if broken:
        raise GateBroken(broken, rows)
    return rows


def gate_spread(n: int, device=None) -> dict:
    """``n`` independent readings of the tracing gate at the smoke mode's
    largest cell on the invocation's fleet path (traced over untraced
    wall clock, min of 3 reps each, as :func:`fleet_rows` takes it): how
    far the host's noise alone moves the ratio, and how many readings
    cross the 1.10 bar."""
    path, dev = paths(device)[-1]
    n_tasks, n_nodes = SMOKE_CELLS[-1]
    ratios = sorted(1.0 + obs_gate(n_tasks, n_nodes, SMOKE_HORIZON_S,
                                   np.inf, 3, path, dev)[0]["trace_overhead"]
                    for _ in range(n))
    return {"path": path, "readings": n,
            "over_bar": sum(r > 1.10 for r in ratios), "ratios": ratios}


def main(smoke: bool = False, device=None) -> list[dict]:
    if smoke:
        horizon, cells, reps = SMOKE_HORIZON_S, SMOKE_CELLS, 1
    else:
        horizon, reps = HORIZON_S, 3
        cells = [(20000, 16), (50000, 64), (100000, 256)]
    try:
        rows = fleet_rows(cells, horizon, reps, paths(device),
                          full=not smoke)
    except GateBroken as e:          # the rows, then the gate
        emit(e.rows, "fleet")
        raise
    emit(rows, "fleet")
    return rows


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--gate-spread", type=int, default=0, metavar="N",
                    help="print N readings of the smoke cell's tracing gate")
    args = ap.parse_args()
    if args.gate_spread:
        print(json.dumps(gate_spread(args.gate_spread, args.device)))
    else:
        main(smoke=args.smoke, device=args.device)
