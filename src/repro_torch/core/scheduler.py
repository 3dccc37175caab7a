"""Task scheduling across heterogeneous edge nodes (paper §II-D), the port
of ``repro.core.scheduler``.

Pipeline: *task brokering* (queue of offloaded AI tasks) → *resource & time
prediction* (the global profiling model supplies the expected-time-to-
compute matrix) → *infrastructure monitoring* (node availability) →
scheduling.

Schedulers: round-robin / random baselines, min-min and max-min list
scheduling (classic ETC heuristics), HEFT-style earliest-finish-time, and
an exact MDP value-iteration formulation for small instances (the paper
frames scheduling as an (PO-)MDP).

The schedulers are sequential scalar work and stay host numpy code, the
reference's arithmetic in its order, so their schedules equal the
reference's bit for bit.  Only the predictions that fill the ETC matrix
run on the torch device (:func:`etc_matrix` with ``cost=``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch._device import DeviceLike
from repro_torch.core.offload import DEFAULT_EFFICIENCY
from repro_torch.hw import DeviceSpec


@dataclasses.dataclass(frozen=True)
class Task:
    """One brokered AI task (a profiling-grid workload or an arch config)."""
    name: str
    flops: float
    input_bytes: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class Node:
    spec: DeviceSpec
    available_at: float = 0.0    # infrastructure monitoring: busy-until

    def exec_time(self, task: Task,
                  efficiency: float = DEFAULT_EFFICIENCY) -> float:
        comp = task.flops / (self.spec.peak_flops_f32 * efficiency)
        xfer = task.input_bytes / max(self.spec.link_bw, 1.0)
        return comp + xfer


@dataclasses.dataclass
class Assignment:
    task: Task
    node: str
    start: float
    finish: float


@dataclasses.dataclass
class Schedule:
    assignments: list[Assignment]

    @property
    def makespan(self) -> float:
        return max((a.finish for a in self.assignments), default=0.0)

    @property
    def mean_completion(self) -> float:
        return float(np.mean([a.finish for a in self.assignments])) \
            if self.assignments else 0.0

    def deadline_misses(self) -> int:
        return sum(1 for a in self.assignments
                   if a.task.deadline_s is not None
                   and a.finish > a.task.deadline_s)


def etc_matrix(tasks: Sequence[Task], nodes: Sequence[Node],
               predictor: Optional[Callable[[Task, Node], float]] = None,
               *, cost=None, device: DeviceLike = None) -> np.ndarray:
    """Expected-time-to-compute matrix [T, N], f64 on the host.

    ``cost`` plugs in a :class:`repro_torch.core.costs.CostModel`: each
    task is costed as running wholly on each node (``PredictorCost``
    batches all (task, node) pairs into one ``predict`` call on the torch
    ``device``, None = cuda; ``CompositeCost`` yields a scalarised
    multi-objective ETC).  ``predictor`` is the older scalar hook — a
    ``(task, node) -> seconds`` callable (paper §II-D: "resource and time
    prediction using global profiling models").  Default is the analytic
    roofline estimate, host arithmetic that ignores ``device``.
    """
    if cost is not None:
        from repro_torch.core.costs import etc_from_cost
        return etc_from_cost(cost, tasks, nodes, device=device)
    fn = predictor or (lambda t, n: n.exec_time(t))
    return np.array([[fn(t, n) for n in nodes] for t in tasks])


def _fresh(nodes: Sequence[Node]) -> list[Node]:
    return [dataclasses.replace(n) for n in nodes]


def masked_argmin(fin: np.ndarray, active: np.ndarray) -> tuple[int, int]:
    """The min-min pick: ``(task, node)`` of the smallest finish time
    among the ``active`` rows of a ``[T, N]`` finish matrix, row-major
    first occurrence on ties.  Shared by the batch :func:`min_min` and
    the incremental streaming scheduler (:mod:`repro_torch.sim.stream`), so
    the two stay tie-break-for-tie-break identical."""
    flat = int(np.argmin(np.where(active[:, None], fin, np.inf)))
    i, j = divmod(flat, fin.shape[1])
    return i, j


def _assign(task, node, etc_tn) -> Assignment:
    start = node.available_at
    finish = start + etc_tn
    node.available_at = finish
    return Assignment(task, node.spec.name, start, finish)


def round_robin(tasks, nodes, etc) -> Schedule:
    nodes = _fresh(nodes)
    out = [_assign(t, nodes[i % len(nodes)], etc[i, i % len(nodes)])
           for i, t in enumerate(tasks)]
    return Schedule(out)


def random_schedule(tasks, nodes, etc, seed: int = 0) -> Schedule:
    rng = np.random.default_rng(seed)
    nodes = _fresh(nodes)
    out = []
    for i, t in enumerate(tasks):
        j = int(rng.integers(len(nodes)))
        out.append(_assign(t, nodes[j], etc[i, j]))
    return Schedule(out)


def min_min(tasks, nodes, etc) -> Schedule:
    """Classic min-min: repeatedly place the task with the smallest
    earliest-completion-time.

    Array-native: one masked argmin over the ``[T, N]`` finish matrix per
    placement; only the placed node's column is refreshed.  Bit-for-bit
    equivalent to :func:`min_min_ref` (same arithmetic, same row-major
    first-occurrence tie-break)."""
    if len(tasks) == 0:
        return Schedule([])
    etc = np.asarray(etc, np.float64).reshape(len(tasks), len(nodes))
    n_t, n_n = etc.shape
    avail = np.asarray([n.available_at for n in nodes], np.float64)
    fin = avail[None, :] + etc
    active = np.ones(n_t, bool)
    out = []
    for _ in range(n_t):
        i, j = masked_argmin(fin, active)
        out.append(Assignment(tasks[i], nodes[j].spec.name,
                              float(avail[j]), float(fin[i, j])))
        avail[j] = fin[i, j]
        active[i] = False
        fin[:, j] = avail[j] + etc[:, j]
    return Schedule(out)


def min_min_ref(tasks, nodes, etc) -> Schedule:
    """Scalar min-min oracle (original nested loops), kept for tests."""
    nodes = _fresh(nodes)
    remaining = list(range(len(tasks)))
    out = []
    while remaining:
        best = None
        for i in remaining:
            for j, n in enumerate(nodes):
                fin = n.available_at + etc[i, j]
                if best is None or fin < best[0]:
                    best = (fin, i, j)
        _, i, j = best
        out.append(_assign(tasks[i], nodes[j], etc[i, j]))
        remaining.remove(i)
    return Schedule(out)


def max_min(tasks, nodes, etc) -> Schedule:
    """max-min: place the *largest* task first (better balance for skew).

    Vectorized like :func:`min_min`: per-row argmin picks each task's best
    node, a masked argmax picks the worst-off task."""
    if len(tasks) == 0:
        return Schedule([])
    etc = np.asarray(etc, np.float64).reshape(len(tasks), len(nodes))
    n_t, n_n = etc.shape
    avail = np.asarray([n.available_at for n in nodes], np.float64)
    fin = avail[None, :] + etc
    active = np.ones(n_t, bool)
    out = []
    for _ in range(n_t):
        masked = np.where(active[:, None], fin, np.inf)
        best_j = np.argmin(masked, axis=1)
        best_fin = masked[np.arange(n_t), best_j]
        i = int(np.argmax(np.where(active, best_fin, -np.inf)))
        j = int(best_j[i])
        out.append(Assignment(tasks[i], nodes[j].spec.name,
                              float(avail[j]), float(fin[i, j])))
        avail[j] = fin[i, j]
        active[i] = False
        fin[:, j] = avail[j] + etc[:, j]
    return Schedule(out)


def max_min_ref(tasks, nodes, etc) -> Schedule:
    """Scalar max-min oracle (original nested loops), kept for tests."""
    nodes = _fresh(nodes)
    remaining = list(range(len(tasks)))
    out = []
    while remaining:
        picks = {}
        for i in remaining:
            fins = [(n.available_at + etc[i, j], j)
                    for j, n in enumerate(nodes)]
            picks[i] = min(fins)
        i = max(picks, key=lambda i_: picks[i_][0])
        fin, j = picks[i]
        out.append(_assign(tasks[i], nodes[j], etc[i, j]))
        remaining.remove(i)
    return Schedule(out)


def heft(tasks, nodes, etc) -> Schedule:
    """HEFT-lite for independent tasks: rank by mean ETC descending, place
    each on the earliest-finish node (argmin over the node-availability
    vector, no per-node Python objects)."""
    if len(tasks) == 0:
        return Schedule([])
    etc = np.asarray(etc, np.float64).reshape(len(tasks), len(nodes))
    avail = np.asarray([n.available_at for n in nodes], np.float64)
    order = np.argsort(-etc.mean(axis=1))
    out = []
    for i in order:
        j = int(np.argmin(avail + etc[i]))
        start = float(avail[j])
        finish = start + float(etc[i, j])
        avail[j] = finish
        out.append(Assignment(tasks[int(i)], nodes[j].spec.name,
                              start, finish))
    return Schedule(out)


def heft_ref(tasks, nodes, etc) -> Schedule:
    """Scalar HEFT-lite oracle (original loops), kept for tests."""
    nodes = _fresh(nodes)
    order = np.argsort(-etc.mean(axis=1))
    out = []
    for i in order:
        j = int(np.argmin([n.available_at + etc[i, j]
                           for j, n in enumerate(nodes)]))
        out.append(_assign(tasks[i], nodes[j], etc[i, j]))
    return Schedule(out)


def optimal_bruteforce(tasks, nodes, etc) -> Schedule:
    """Exact minimum-makespan assignment (tiny instances only)."""
    best = None
    for combo in itertools.product(range(len(nodes)), repeat=len(tasks)):
        loads = np.zeros(len(nodes))
        for i, j in enumerate(combo):
            loads[j] += etc[i, j]
        mk = loads.max()
        if best is None or mk < best[0]:
            best = (mk, combo)
    _, combo = best
    nodes = _fresh(nodes)
    return Schedule([_assign(tasks[i], nodes[j], etc[i, j])
                     for i, j in enumerate(combo)])


SCHEDULERS: dict[str, Callable] = {
    "round_robin": round_robin,
    "random": random_schedule,
    "min_min": min_min,
    "max_min": max_min,
    "heft": heft,
}

# scalar oracles, exercised by the equivalence tests and benchmarks
SCHEDULERS_REF: dict[str, Callable] = {
    "min_min": min_min_ref,
    "max_min": max_min_ref,
    "heft": heft_ref,
}


# --------------------------------------------------------------------------
# MDP formulation (paper: "modelled as an MDP or PO-MDP")
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SchedulingMDP:
    """Exact finite-horizon MDP for sequential task arrival.

    State: (next task index, discretised node-backlog vector).
    Action: node for the current task.  Cost: increase in makespan.
    Solved by backward value iteration — the optimal policy lower-bounds
    the heuristics on small instances (tested).
    """
    tasks: Sequence[Task]
    nodes: Sequence[Node]
    etc: np.ndarray
    backlog_levels: int = 8

    def solve(self) -> float:
        levels = self.backlog_levels
        etc = self.etc
        t_max = etc.sum()
        step = t_max / (levels - 1) if levels > 1 else t_max

        def discretise(b: float) -> int:
            return min(int(round(b / step)), levels - 1)

        n_nodes = len(self.nodes)
        from functools import lru_cache

        @lru_cache(maxsize=None)
        def value(i: int, backlog: tuple) -> float:
            if i == len(self.tasks):
                return max(backlog) * step
            best = np.inf
            for j in range(n_nodes):
                b = list(backlog)
                b[j] = discretise(b[j] * step + etc[i, j])
                best = min(best, value(i + 1, tuple(b)))
            return best

        return float(value(0, tuple([0] * n_nodes)))
