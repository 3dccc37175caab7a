"""Streaming re-plan benchmark of the port: incremental against
from-scratch re-planning per arrival, the counterpart of
``benchmarks/bench_stream.py``.

Sweeps Poisson arrival rate x cluster size and re-plans on every arrival
two ways:

  * ``incremental`` — :class:`repro_torch.sim.StreamScheduler`: the
                      persistent ``[T, N]`` finish/ETC state grows by the
                      arriving row, nothing is ever rebuilt;
  * ``fromscratch`` — every arrival recomputes the full ETC matrix over
                      all tasks so far and replays batch ``min_min``.

Both are host numpy code in the port, as in the reference (the analytic
ETC has no tensor path): the rows are the CPU's (``plain: true``), and a
run on the card emits the same rows.  Gate (every run): the incremental
scheduler no slower than from-scratch at the largest cell, and no full
rebuild.  :func:`cell` is the cell's tasks, arrivals and cluster, which
``chip_smoke.py`` streams through the oracle and the pools.

Run:  PYTHONPATH=src python -m repro_torch.bench.stream [--device cpu] \\
          [--smoke]

Rows go to ``results/bench_torch_stream.json``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.bench.common import emit, parser, paths, require, tag
from repro_torch.core import scheduler as sch
from repro_torch.hw import EDGE_DEVICES
from repro_torch.sim import StreamScheduler, poisson_arrivals

TIMED = ("us_per_arrival", "total_ms", "speedup_vs_fromscratch")
CELLS = [(50.0, 8), (200.0, 8), (50.0, 32), (200.0, 32)]


def make_cluster(n_nodes: int) -> list[sch.Node]:
    specs = list(EDGE_DEVICES.values())
    return [sch.Node(specs[j % len(specs)]) for j in range(n_nodes)]


def make_tasks(n: int, seed: int = 0) -> list[sch.Task]:
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)))
            for i in range(n)]


def cell(rate: float, n_nodes: int, n_tasks: int) -> tuple:
    """(tasks, arrivals, nodes) of one cell, seeded as the reference
    seeds it."""
    return (make_tasks(n_tasks, seed=int(rate) + n_nodes),
            poisson_arrivals(rate, n=n_tasks, seed=int(rate) * 7 + n_nodes),
            make_cluster(n_nodes))


def run_incremental(tasks, arrivals, nodes) -> float:
    """Wall seconds to stream every arrival through StreamScheduler."""
    s = StreamScheduler(nodes, device="cpu")
    t0 = time.perf_counter()
    s.run(tasks, arrivals)
    dt = time.perf_counter() - t0
    require(s.full_rebuilds == 0 and s.rows_built == len(tasks),
            f"{s.full_rebuilds} full rebuilds, {s.rows_built} rows built "
            f"for {len(tasks)} tasks")
    return dt


def run_fromscratch(tasks, arrivals, nodes) -> float:
    """Wall seconds for the naive baseline: per arrival, rebuild the ETC
    matrix over all tasks so far and replay batch min_min."""
    t0 = time.perf_counter()
    for k in range(1, len(tasks) + 1):
        etc = sch.etc_matrix(tasks[:k], nodes)
        sch.min_min(tasks[:k], nodes, etc)
    return time.perf_counter() - t0


def stream_rows(cells, n_tasks: int, reps: int) -> list[dict]:
    rows: list[dict] = []
    for rate, n_nodes in cells:
        tasks, arrivals, nodes = cell(rate, n_nodes, n_tasks)
        t_inc = min(run_incremental(tasks, arrivals, nodes)
                    for _ in range(reps))
        t_scr = min(run_fromscratch(tasks, arrivals, nodes)
                    for _ in range(reps))
        for name, dt in (("incremental", t_inc), ("fromscratch", t_scr)):
            rows.append(tag({
                "name": f"stream_{name}_r{rate:.0f}_n{n_nodes}",
                "scheduler": name,
                "rate_eps": rate,
                "n_nodes": n_nodes,
                "n_tasks": n_tasks,
                "us_per_arrival": dt / n_tasks * 1e6,
                "total_ms": dt * 1e3,
            }, "cpu"))
        # the makespan belongs to the incremental row only
        rows[-2]["makespan_s"] = StreamScheduler(
            make_cluster(n_nodes), device="cpu").run(tasks,
                                                     arrivals).makespan
        rows[-2]["speedup_vs_fromscratch"] = t_scr / t_inc
        if (rate, n_nodes) == cells[-1]:
            # the gate: incremental must not lose to a full rebuild
            require(t_inc <= t_scr, (
                f"incremental streaming re-plan slower than from-scratch "
                f"min_min at the largest config (rate={rate}, "
                f"n_nodes={n_nodes}): {t_inc*1e3:.1f}ms vs "
                f"{t_scr*1e3:.1f}ms"))
    return rows


def main(smoke: bool = False, device=None) -> list[dict]:
    paths(device)                    # the card, unless asked for the CPU
    rows = stream_rows(CELLS, 80 if smoke else 300, 1 if smoke else 3)
    emit(rows, "stream")
    return rows


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    main(smoke=args.smoke, device=args.device)
