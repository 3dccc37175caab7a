"""repro_torch.sim — the event-driven streaming offload simulator (the
port of ``repro.sim``, in part).

Tasks arrive over virtual time (Poisson, trace, Markov-modulated,
diurnal), link bandwidth drifts as seeded stochastic processes, and the
decision core (``repro_torch.core.decisions`` / ``costs`` and the
``decide_split`` kernel) is driven *online* through state snapshots:
incremental re-planning on the live ``[T, N]`` finish matrix
(:class:`StreamScheduler`), with run telemetry in the record schema the
batch benchmarks emit.

  * events    — virtual clock, event heap, arrival processes
  * state     — drifting links snapshotted into ``EnvArrays``
  * stream    — incremental online min-min/HEFT + the event loop
  * telemetry — p50/p99, misses, energy, utilisation, re-plan counts

``queueing``, ``pareto`` and the fleet engine come in a later slice
(ROADMAP.md §1 item 6).
"""
from repro_torch.sim.events import (Clock, Event, EventQueue,
                                    diurnal_arrivals, mmpp_arrivals,
                                    poisson_arrivals, trace_arrivals)
from repro_torch.sim.state import (ClusterLinks, DiurnalLink, DriftingEnv,
                                   FixedLink, LinkProcess, RandomWalkLink,
                                   TwoStateLink, step_batch)
from repro_torch.sim.stream import StreamScheduler, simulate_stream
from repro_torch.sim.telemetry import TaskRecord, Telemetry

__all__ = [
    "Clock", "Event", "EventQueue", "poisson_arrivals", "trace_arrivals",
    "mmpp_arrivals", "diurnal_arrivals", "LinkProcess", "FixedLink",
    "RandomWalkLink", "TwoStateLink", "DiurnalLink", "DriftingEnv",
    "ClusterLinks", "step_batch", "StreamScheduler", "simulate_stream",
    "TaskRecord", "Telemetry",
]
