"""The fleet engine's traced run, held to the Chrome export it wrote
before its trace emission was deferred to the first read.

Four seeded cells of ``simulate_stream(engine="fleet")`` (link drift with
an RTT; node pools with an RTT; the Pareto planner's splits; the
decide-at-admission splits), each traced with ``repro_torch.obs.Tracer``:
the export's events, serialised with sorted keys, hash to the digest the
earlier code's export gave (``GOLDEN``: its event count and SHA-256), so
every span, instant, argument and timestamp is as it was; and
``validate_chrome`` passes.  The untraced run's records equal the traced
run's.
"""
import hashlib
import json

import numpy as np
import pytest
import torch

from repro_torch import sim as psim
from repro_torch.core import scheduler as psch
from repro_torch.core.offload import workload_layer_costs
from repro_torch.core.workloads import WorkloadConfig
from repro_torch.hw import EDGE_DEVICES, get_device
from repro_torch.obs import Tracer, validate_chrome

CPU = torch.device("cpu")
N_TASKS, N_NODES = 160, 4

#: (events, sha256 of the sorted-key JSON of ``traceEvents``) per cell,
#: written by the engine before its deferred columns
GOLDEN = {
    "links_rtt": (1491, "6c6ede2df55c131bcca856aa0938a7f4"
                        "91e78f0b77a97e0bc03c9c252d5e6435"),
    "pools_rtt": (1578, "0cb8a443c7d4e359c563656dbaa52f5b"
                        "7a70bf159ba5846c2af387fea4dc730f"),
    "planner": (1277, "cdd3783b9d1397a1ade72fc48c2aa77e"
                      "a263ce1b3e652b164569ce9b40e13b83"),
    "decide": (1171, "616112b29d85673511474d254b0ec3a7"
                     "d72bb07ad890c8ba37013e09f0ab05d4"),
}


def _tasks():
    rng = np.random.default_rng(21)
    return [psch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e7)),
                      deadline_s=float(rng.uniform(0.02, 2.0)))
            for i in range(N_TASKS)]


def _layers():
    return workload_layer_costs(WorkloadConfig(
        "cnn", 2, epochs=5, optimiser="adam", lr=1e-3, batch_size=32))


def _env():
    return psim.DriftingEnv(get_device("pi5-arm"),
                            get_device("edge-server-a100"),
                            psim.TwoStateLink(80e6, 8e6, seed=23),
                            input_bytes=2e6, torch_device=CPU)


def _links():
    return psim.ClusterLinks.random_walk(
        [40e6 + 5e6 * j for j in range(N_NODES)], sigma=0.4, seed=22)


def _kw(cell):
    if cell == "links_rtt":
        return dict(links=_links(), link_update_dt=0.5,
                    rtt=psim.WeibullRTT(shape=0.7, scale=0.01, seed=24))
    if cell == "pools_rtt":
        return dict(pools=psim.NodePools.uniform(N_NODES, 2),
                    rtt=psim.WeibullRTT(shape=0.7, scale=0.01, seed=24))
    if cell == "planner":
        return dict(split_planner=psim.ParetoStreamScheduler(
                        torch_device=CPU),
                    split_env=_env(), split_layers=_layers(),
                    pools=psim.NodePools.uniform(N_NODES, 1),
                    link_update_dt=0.1)
    if cell == "decide":
        return dict(split_env=_env(), split_layers=_layers(),
                    links=_links(), link_update_dt=0.5)
    raise ValueError(cell)


def _run(cell, obs):
    specs = list(EDGE_DEVICES.values())
    nodes = [psch.Node(specs[j % len(specs)]) for j in range(N_NODES)]
    arrivals = psim.poisson_arrivals(20.0, n=N_TASKS, seed=25)
    return psim.simulate_stream(_tasks(), arrivals, nodes, policy="min_min",
                                engine="fleet", obs=obs, device=CPU,
                                **_kw(cell))


def _digest(trace) -> tuple[int, str]:
    events = trace["traceEvents"]
    blob = json.dumps(events, sort_keys=True, default=float)
    return len(events), hashlib.sha256(blob.encode()).hexdigest()


@pytest.mark.parametrize("cell", ["links_rtt", "pools_rtt", "planner",
                                  "decide"])
def test_fleet_trace_export_is_unchanged(cell):
    tracer = Tracer()
    traced = _run(cell, tracer)
    untraced = _run(cell, None)
    assert [dataclass_tuple(r) for r in traced.records] == \
        [dataclass_tuple(r) for r in untraced.records]
    trace = tracer.export_chrome(None)
    stats = validate_chrome(trace)
    assert stats["n_spans"] >= 2 * N_TASKS
    assert _digest(trace) == GOLDEN[cell]


def dataclass_tuple(r):
    return (r.name, r.arrived_s, r.started_s, r.finished_s, r.node,
            r.node_id, r.deadline_s, r.energy_j, r.split, r.switches,
            r.transfer_s)
