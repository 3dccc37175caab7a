"""repro_torch.sim — the event-driven streaming offload simulator (the
port of ``repro.sim``).

Tasks arrive over virtual time (Poisson, trace, Markov-modulated,
diurnal), link bandwidth and node backlog drift as seeded stochastic
processes, and the decision core (``repro_torch.core.decisions`` /
``costs`` and the ``decide_split`` kernel) is driven *online* through state
snapshots: incremental re-planning on the live ``[T, N]`` finish matrix
(:class:`StreamScheduler`) and Pareto-front re-picking of offload splits
(:class:`ParetoStreamScheduler`), with run telemetry in the record schema
the batch benchmarks emit.

  * events    — virtual clock, event heap, arrival processes
  * state     — drifting links snapshotted into ``EnvArrays``
  * stream    — incremental online min-min/HEFT + the event loop
  * fleet     — time-slabbed twin of the event loop
                (``simulate_stream(..., engine="fleet")``), its singleton
                runs placed by the ``fleet_scan`` kernel
  * pareto    — live Pareto-front split re-picking
  * queueing  — finite-capacity server pools, heavy-tailed RTT
                processes, Erlang-C/M/M/c validation closed forms
  * telemetry — p50/p99, misses, energy, utilisation, queue waits,
                re-plan counts
"""
from repro_torch.sim.events import (Clock, Event, EventQueue,
                                    diurnal_arrivals, mmpp_arrivals,
                                    poisson_arrivals, trace_arrivals)
from repro_torch.sim.fleet import decide_all_sharded, simulate_fleet
from repro_torch.sim.pareto import PARETO_OBJECTIVES, ParetoStreamScheduler
from repro_torch.sim.queueing import (DelayProcess, LognormalRTT, NodePools,
                                      ServerPool, WeibullRTT, erlang_c,
                                      mm1_sojourn, mmc_sojourn,
                                      spawn_streams)
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
    "simulate_fleet", "decide_all_sharded", "ParetoStreamScheduler",
    "PARETO_OBJECTIVES", "TaskRecord", "Telemetry", "ServerPool",
    "NodePools", "DelayProcess", "WeibullRTT", "LognormalRTT",
    "erlang_c", "mm1_sojourn", "mmc_sojourn", "spawn_streams",
]
