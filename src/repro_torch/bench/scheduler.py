"""Task-scheduling comparison of the port (paper §II-D): makespan, mean
completion and deadline misses per scheduler over the heterogeneous edge
cluster, the counterpart of ``benchmarks/bench_scheduler.py``.

The schedulers and the analytic ETC matrix are host numpy code in the port
as in the reference, so the rows are the CPU's (``plain: true``) and equal
the reference's bit for bit; a run on the card emits the same rows.

Run:  PYTHONPATH=src python -m repro_torch.bench.scheduler [--device cpu]

Rows go to ``results/bench_torch_scheduler.json``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.common import emit, parser, paths, tag
from repro_torch.core import scheduler as sch
from repro_torch.hw import EDGE_DEVICES

TIMED = ()


def sched_rows(n_tasks: int = 40, seed: int = 0) -> list[dict]:
    rng = np.random.default_rng(seed)
    nodes = [sch.Node(spec) for spec in EDGE_DEVICES.values()]
    tasks = [sch.Task(f"t{i}",
                      flops=float(rng.lognormal(25, 1.2)),
                      input_bytes=float(rng.lognormal(13, 1.0)),
                      deadline_s=float(rng.uniform(0.5, 5.0)))
             for i in range(n_tasks)]
    etc = sch.etc_matrix(tasks, nodes)
    rows = []
    for name, fn in sch.SCHEDULERS.items():
        s = fn(tasks, nodes, etc)
        rows.append(tag({
            "name": f"sched_{name}",
            "us_per_call": s.makespan * 1e6,
            "makespan_s": s.makespan,
            "mean_completion_s": s.mean_completion,
            "deadline_misses": s.deadline_misses(),
        }, "cpu"))
    return rows


def main(n_tasks: int = 40, seed: int = 0, device=None) -> list[dict]:
    paths(device)                    # the card, unless asked for the CPU
    rows = sched_rows(n_tasks, seed)
    emit(rows, "scheduler")
    return rows


if __name__ == "__main__":
    args = parser(__doc__, smoke=False).parse_args()
    main(device=args.device)
