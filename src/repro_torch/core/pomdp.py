"""PO-MDP task scheduling (paper §II-D: "... modelled as an MDP or a
Partially Observable (PO)-MDP, depending on the completeness of state
information from all nodes"), the port of ``repro.core.pomdp``: host numpy
code, drawing from the reference's generators in its order.

The partially-observable case: node load is hidden; the broker only sees
noisy, delayed observations (the realistic monitoring situation the paper
describes).  We maintain a Bayesian belief over each node's load state and
schedule greedily on belief-expected completion time — the standard QMDP
approximation — and compare against (a) the omniscient MDP scheduler and
(b) an oblivious scheduler that ignores monitoring entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import Node, Task

# discrete hidden load states: idle / busy / overloaded (slowdown factors)
LOAD_STATES = np.array([1.0, 2.0, 4.0])
N_STATES = len(LOAD_STATES)

# load Markov dynamics between task arrivals
TRANSITION = np.array([
    [0.8, 0.15, 0.05],
    [0.2, 0.6, 0.2],
    [0.05, 0.25, 0.7],
])

# observation model: monitoring reports the true state with prob ``acc``
def observation_matrix(acc: float) -> np.ndarray:
    off = (1.0 - acc) / (N_STATES - 1)
    return np.full((N_STATES, N_STATES), off) + \
        (acc - off) * np.eye(N_STATES)


@dataclasses.dataclass
class BeliefScheduler:
    """QMDP belief-state scheduler."""
    nodes: Sequence[Node]
    obs_accuracy: float = 0.8
    seed: int = 0

    def __post_init__(self):
        n = len(self.nodes)
        self.belief = np.full((n, N_STATES), 1.0 / N_STATES)
        self.obs_m = observation_matrix(self.obs_accuracy)
        self.rng = np.random.default_rng(self.seed)

    def observe(self, node_idx: int, obs_state: int) -> None:
        """Bayes update from a (noisy) monitoring report."""
        b = self.belief[node_idx] @ TRANSITION        # predict
        b = b * self.obs_m[:, obs_state]              # correct
        self.belief[node_idx] = b / b.sum()

    def expected_slowdown(self, node_idx: int) -> float:
        return float(self.belief[node_idx] @ LOAD_STATES)

    def pick(self, task: Task) -> int:
        """Belief-expected earliest completion."""
        etcs = [n.exec_time(task) * self.expected_slowdown(i)
                + n.available_at
                for i, n in enumerate(self.nodes)]
        return int(np.argmin(etcs))


def simulate(tasks: Sequence[Task], nodes: Sequence[Node], *,
             obs_accuracy: float = 0.8, policy: str = "belief",
             seed: int = 0) -> float:
    """Run the arrival process; returns the makespan.

    policy: "belief" (QMDP), "omniscient" (sees true loads), "oblivious"
    (assumes all nodes idle).
    """
    rng = np.random.default_rng(seed)
    nodes = [dataclasses.replace(n, available_at=0.0) for n in nodes]
    true_state = rng.integers(0, N_STATES, size=len(nodes))
    sched = BeliefScheduler(nodes, obs_accuracy=obs_accuracy,
                            seed=seed + 1)
    obs_m = observation_matrix(obs_accuracy)
    for t in tasks:
        # hidden load evolves
        for i in range(len(nodes)):
            true_state[i] = rng.choice(N_STATES,
                                       p=TRANSITION[true_state[i]])
        # monitoring reports (noisy)
        for i in range(len(nodes)):
            obs = rng.choice(N_STATES, p=obs_m[true_state[i]])
            sched.observe(i, int(obs))
        if policy == "belief":
            j = sched.pick(t)
        elif policy == "omniscient":
            j = int(np.argmin([
                n.exec_time(t) * LOAD_STATES[true_state[i]]
                + n.available_at for i, n in enumerate(nodes)]))
        else:                              # oblivious
            j = int(np.argmin([n.exec_time(t) + n.available_at
                               for n in nodes]))
        real = nodes[j].exec_time(t) * LOAD_STATES[true_state[j]]
        nodes[j].available_at += real
    return max(n.available_at for n in nodes)
