"""The port's fleet engine (``repro_torch.sim.fleet``) against the JAX
package's streaming simulator, on the CPU.

The fleet engine's contract is bit-for-bit f64 equality with the event
loop, so everything here is exact ``==``: each configuration runs through
the reference's event loop and through the port's event loop and fleet
engine, and records, ``summary()``, counters and the drift processes' end
states must all be equal.  (The reference's own fleet engine takes its
jitted scan only under ``enable_x64``, which the installed JAX lacks; its
host loop is what ``tests/test_fleet.py`` pins it to, and what these tests
pin the port to.)  A hypothesis property sweeps small configurations over
all four arrival processes × all four link processes × both policies ×
(no splits / Pareto planner / decide-at-admission) × (believed /
ground-truth service times); pins cover exact ties on link ticks; runs of
at least 512 single-task batches go through ``fleet_scan``'s plain version
and must equal the reference; ``split_backend="sharded"`` equals the
reference's numpy ``decide_all``.
"""
import os
import tempfile

import numpy as np
import pytest
import torch
from hypothesis_shim import given, settings, st

from repro import sim as rsim
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.core.workloads import WorkloadConfig as RWorkload
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get
from repro.obs import Tracer

from repro_torch import sim as psim
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.core.workloads import WorkloadConfig as PWorkload
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get
from repro_torch.kernels.fleet_scan import kernel as scan_kernel
from repro_torch.kernels.fleet_scan import ops as scan_ops
from repro_torch.kernels.fleet_scan import ref as scan_ref
from repro_torch.sim import fleet as pfleet

CPU = "cpu"
R_SPECS, P_SPECS = list(R_DEVICES.values()), list(P_DEVICES.values())
PACKS = {False: (rsim, rsch, R_SPECS, r_get, roff, RWorkload),
         True: (psim, psch, P_SPECS, p_get, poff, PWorkload)}


def make_tasks(sch, n, seed=3, deadlines=False):
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)),
                     deadline_s=float(rng.uniform(0.02, 2.0))
                     if deadlines else None)
            for i in range(n)]


def make_nodes(sch, specs, n):
    return [sch.Node(specs[j % len(specs)]) for j in range(n)]


def make_links(sim, kind, n, seed):
    if kind == "fixed":
        return sim.ClusterLinks([sim.FixedLink(50e6 * (j + 1))
                                 for j in range(n)])
    if kind == "walk":
        return sim.ClusterLinks.random_walk(
            [40e6 + 5e6 * j for j in range(n)], sigma=0.4, seed=seed)
    if kind == "twostate":
        return sim.ClusterLinks([sim.TwoStateLink(20e6 * (j + 1),
                                                  4e6 * (j + 1),
                                                  seed=seed + j)
                                 for j in range(n)])
    return sim.ClusterLinks([sim.DiurnalLink(30e6 + 10e6 * j,
                                             amplitude=0.6, period_s=7.0,
                                             noise_sigma=0.2,
                                             seed=seed + j)
                             for j in range(n)])


def make_link_process(sim, kind, seed):
    return {"fixed": lambda: sim.FixedLink(60e6),
            "walk": lambda: sim.RandomWalkLink(60e6, sigma=0.5, seed=seed),
            "twostate": lambda: sim.TwoStateLink(80e6, 8e6, seed=seed),
            "diurnal": lambda: sim.DiurnalLink(60e6, amplitude=0.7,
                                               period_s=5.0,
                                               noise_sigma=0.3,
                                               seed=seed)}[kind]()


def make_env(port, kind, seed):
    sim, _, _, get, _, _ = PACKS[port]
    extra = {"torch_device": CPU} if port else {}
    return sim.DriftingEnv(get("jetson-orin-nano"), get("edge-server-a100"),
                           make_link_process(sim, kind, seed),
                           input_bytes=2e6, **extra)


def cnn_layers(port):
    _, _, _, _, off, workload = PACKS[port]
    return off.workload_layer_costs(workload("cnn", 2, epochs=5,
                                             optimiser="adam", lr=1e-3,
                                             batch_size=32))


LAYERS = {port: cnn_layers(port) for port in (False, True)}


def rec_tuple(r):
    return (r.name, r.arrived_s, r.started_s, r.finished_s, r.node,
            r.node_id, r.deadline_s, r.energy_j, r.split, r.switches,
            r.transfer_s)


def make_arrivals(sim, kind, n, seed):
    if kind == "poisson":
        return sim.poisson_arrivals(8.0, n=n, seed=seed)
    if kind == "trace":                  # coarse grid: forces exact ties
        rng = np.random.default_rng(seed)
        return np.sort(np.round(rng.uniform(0, 3, n), 1))
    if kind == "mmpp":
        a = sim.mmpp_arrivals([5.0, 60.0], [0.5, 0.2], horizon=6.0,
                              seed=seed)
    else:
        a = sim.diurnal_arrivals(10.0, horizon=6.0, amplitude=0.8,
                                 period_s=2.0, seed=seed)
    if len(a) >= n:
        return a[:n]
    return np.concatenate([a, 6.0 + np.arange(n - len(a), dtype=float)])


def run_three(*, n_tasks, n_nodes, arrival, linkkind, policy, mode,
              ground_truth, seed, dt=0.5):
    """One configuration through the reference's event loop, then the
    port's event loop and fleet engine (fresh stateful processes each) ->
    [(Telemetry, end link values)] × 3."""
    out = []
    for port, engine in ((False, "event"), (True, "event"),
                         (True, "fleet")):
        sim, sch, specs, _, _, _ = PACKS[port]
        links = make_links(sim, linkkind, n_nodes, seed + 100)
        kw = {"device": CPU} if port else {}
        if mode == "planner":
            kw["split_planner"] = sim.ParetoStreamScheduler(
                **({"torch_device": CPU} if port else {}))
        if mode in ("planner", "decide"):
            kw["split_env"] = make_env(port, linkkind, seed + 7)
            kw["split_layers"] = LAYERS[port]
        if mode == "decide":
            kw["split_backend"] = "torch" if port else "numpy"
        if ground_truth:
            kw["service_time_fn"] = \
                lambda task, spec, etc, start: etc * (
                    1.1 + 0.2 * np.sin(start + task.flops * 1e-12))
        tel = sim.simulate_stream(
            make_tasks(sch, n_tasks, seed=seed, deadlines=True),
            make_arrivals(sim, arrival, n_tasks, seed),
            make_nodes(sch, specs, n_nodes), policy=policy, links=links,
            link_update_dt=dt, engine=engine, **kw)
        out.append((tel, links.values()))
    return out


def assert_bit_for_bit(runs):
    (want, lv), others = runs[0], runs[1:]
    for tel, lv_got in others:
        assert [rec_tuple(r) for r in tel.records] \
            == [rec_tuple(r) for r in want.records]
        assert tel.summary() == want.summary()
        assert tel.counters == want.counters
        np.testing.assert_array_equal(lv_got, lv)


# --------------------------------------------------------------------------
# the fleet engine == the event loops, bit for bit
# --------------------------------------------------------------------------
@given(data=st.data())
@settings(max_examples=40, deadline=None)
def test_fleet_equivalence_property(data):
    cfg = dict(
        n_tasks=data.draw(st.integers(1, 32), label="n_tasks"),
        n_nodes=data.draw(st.integers(1, 8), label="n_nodes"),
        arrival=data.draw(st.sampled_from(
            ["poisson", "trace", "mmpp", "diurnal"]), label="arrival"),
        linkkind=data.draw(st.sampled_from(
            ["fixed", "walk", "twostate", "diurnal"]), label="link"),
        policy=data.draw(st.sampled_from(["min_min", "heft"]),
                         label="policy"),
        mode=data.draw(st.sampled_from(["none", "planner", "decide"]),
                       label="mode"),
        ground_truth=data.draw(st.booleans(), label="ground_truth"),
        dt=data.draw(st.sampled_from([0.25, 0.5, 1.0]), label="dt"),
        seed=data.draw(st.integers(0, 2**16), label="seed"))
    assert_bit_for_bit(run_three(**cfg))


@pytest.mark.parametrize("arrival,linkkind,policy,mode,ground_truth", [
    ("poisson", "walk", "min_min", "none", False),
    ("poisson", "walk", "min_min", "none", True),
    ("trace", "twostate", "heft", "none", True),
    ("mmpp", "diurnal", "min_min", "planner", False),
    ("diurnal", "fixed", "heft", "planner", True),
    ("trace", "walk", "min_min", "decide", False),
    ("poisson", "diurnal", "heft", "decide", True),
])
def test_fleet_equivalence_pins(arrival, linkkind, policy, mode,
                                ground_truth):
    assert_bit_for_bit(run_three(
        n_tasks=13, n_nodes=4, arrival=arrival, linkkind=linkkind,
        policy=policy, mode=mode, ground_truth=ground_truth, seed=5))


@pytest.mark.parametrize("policy,ground_truth", [
    ("min_min", False), ("min_min", True), ("heft", False), ("heft", True),
])
def test_fleet_scan_path_equivalence(policy, ground_truth, monkeypatch):
    """1,500 Poisson arrivals are one run of single-task batches, past
    ``_SCAN_MIN``: the whole run goes through ``fleet_scan`` (its plain
    version on the CPU) and stays bit for bit with the reference."""
    calls = []
    real = scan_ops.place_singletons

    def counting(*args):
        calls.append(int(args[3].numel()))
        return real(*args)

    monkeypatch.setattr(scan_ops, "place_singletons", counting)
    assert_bit_for_bit(run_three(
        n_tasks=1500, n_nodes=8, arrival="poisson", linkkind="walk",
        policy=policy, mode="none", ground_truth=ground_truth, seed=11,
        dt=1.0))
    assert calls == [1500]


def test_short_singleton_runs_stay_on_the_host(monkeypatch):
    """Below ``_SCAN_MIN`` single-task batches are placed by the host loop,
    as in the reference."""
    monkeypatch.setattr(scan_ops, "place_singletons",
                        lambda *a: pytest.fail("scan called"))
    assert_bit_for_bit(run_three(
        n_tasks=pfleet._SCAN_MIN - 1, n_nodes=4, arrival="poisson",
        linkkind="walk", policy="min_min", mode="none",
        ground_truth=False, seed=3, dt=1.0))


def test_fleet_tick_collisions():
    """Arrivals exactly on link ticks (they pop before the tick), and a
    completion exactly on a tick (it keeps one extra tick alive iff it
    arrived after the previous tick)."""
    def on_tick(task, spec, etc, start):
        return float(np.ceil(start + etc) - start)

    for arr, truth in [([0.0, 1.0, 1.0, 2.0, 3.0, 3.0], None),
                       ([0.0, 0.3, 1.0, 1.7, 2.0, 2.4], on_tick)]:
        runs = []
        for port, engine in ((False, "event"), (True, "event"),
                             (True, "fleet")):
            sim, sch, specs, _, _, _ = PACKS[port]
            tasks = [sch.Task(f"t{i}", flops=1e11 * (i + 1),
                              input_bytes=1e6) for i in range(6)]
            links = sim.ClusterLinks.random_walk([4e7] * 3, sigma=0.5,
                                                 seed=3)
            kw = {"device": CPU} if port else {}
            if truth is not None:
                kw["service_time_fn"] = truth
            runs.append((sim.simulate_stream(
                tasks, arr, make_nodes(sch, specs, 3), links=links,
                link_update_dt=1.0, engine=engine, **kw), links.values()))
        assert_bit_for_bit(runs)


def test_fleet_edge_configs():
    """Empty runs, a single static task, duplicate task objects in one
    batch, drift disabled (dt = 0), callable split_layers."""
    def cases(port):
        sim, sch, specs, _, _, _ = PACKS[port]
        t = sch.Task("x", flops=2e11, input_bytes=5e6)
        tasks = [sch.Task(f"t{i}", flops=1e11 * (i + 1), input_bytes=1e6)
                 for i in range(4)]
        lay = LAYERS[port]
        return [
            dict(tasks=[], arrivals=[], nodes=make_nodes(sch, specs, 2)),
            dict(tasks=[], arrivals=[], nodes=make_nodes(sch, specs, 3),
                 links=lambda: sim.ClusterLinks.random_walk([4e7] * 3,
                                                            seed=1)),
            dict(tasks=[t], arrivals=[0.0], nodes=make_nodes(sch, specs, 2)),
            dict(tasks=[t, t, t], arrivals=[0.5, 0.5, 0.5],
                 nodes=make_nodes(sch, specs, 3),
                 links=lambda: sim.ClusterLinks.random_walk([4e7] * 3,
                                                            seed=2)),
            dict(tasks=tasks, arrivals=[0.0, 0.5, 1.0, 1.5],
                 nodes=make_nodes(sch, specs, 2), link_update_dt=0.0,
                 links=lambda: sim.ClusterLinks.random_walk([4e7] * 2,
                                                            seed=5)),
            dict(tasks=tasks, arrivals=[0.0, 0.5, 1.0, 1.5],
                 nodes=make_nodes(sch, specs, 2),
                 split_env=lambda: make_env(port, "walk", 9),
                 split_layers=lambda task: lay,
                 split_backend="torch" if port else "numpy"),
        ]

    for k in range(6):
        runs = []
        for port, engine in ((False, "event"), (True, "event"),
                             (True, "fleet")):
            case = cases(port)[k]
            kw = {key: (v() if key in ("links", "split_env") else v)
                  for key, v in case.items()}
            if port:
                kw["device"] = CPU
            links = kw.get("links")
            runs.append((PACKS[port][0].simulate_stream(engine=engine, **kw),
                         None if links is None else links.values()))
        if runs[0][1] is None:
            runs = [(tel, np.zeros(0)) for tel, _ in runs]
        assert_bit_for_bit(runs)


def test_fleet_rejects_sequential_features():
    tasks, arr = make_tasks(psch, 3), [0.0, 0.1, 0.2]
    nodes = make_nodes(psch, P_SPECS, 2)
    for kw, msg in [(dict(oracle=object()), "oracle"),
                    (dict(rebalance=True), "rebalance"),
                    (dict(cost=object()), "cost"),
                    (dict(saturation_threshold=0.5),
                     "saturation_threshold"),
                    (dict(policy="fifo"), "policy")]:
        with pytest.raises(ValueError, match=msg):
            psim.simulate_fleet(tasks, arr, nodes, device=CPU, **kw)

    class NoBatchPlanner:                  # lacks admit_batch
        def admit(self, *a, **k):
            pass

    with pytest.raises(ValueError, match="admit_batch"):
        psim.simulate_fleet(tasks, arr, nodes,
                            split_planner=NoBatchPlanner(),
                            split_env=make_env(True, "fixed", 0),
                            split_layers=LAYERS[True], device=CPU)
    for engine in ("event", "fleet"):
        with pytest.raises(ValueError, match="split_cost"):
            psim.simulate_stream(
                tasks, arr, nodes, engine=engine, device=CPU,
                split_planner=psim.ParetoStreamScheduler(torch_device=CPU),
                split_env=make_env(True, "fixed", 0),
                split_layers=LAYERS[True], split_cost=object())
        with pytest.raises(ValueError, match="split_env"):
            psim.simulate_stream(
                tasks, arr, nodes, engine=engine, device=CPU,
                split_planner=psim.ParetoStreamScheduler(torch_device=CPU))
    with pytest.raises(ValueError, match="engine"):
        psim.simulate_stream(tasks, arr, nodes, engine="warp", device=CPU)


def test_traced_fleet_run_equals_untraced_and_matches_event_spans():
    """A ``repro.obs`` tracer on the fleet engine receives the column
    batches (``instant_arrays``, ``span_arrays``) and moves no number."""
    kw = dict(links=None, link_update_dt=0.5, device=CPU, engine="fleet")
    tasks, nodes = make_tasks(psch, 20, deadlines=True), \
        make_nodes(psch, P_SPECS, 3)
    arr = psim.poisson_arrivals(10.0, n=20, seed=2)
    plain = psim.simulate_stream(tasks, arr, nodes, **kw)
    tracer = Tracer()
    traced = psim.simulate_stream(tasks, arr, nodes, obs=tracer, **kw)
    assert [rec_tuple(r) for r in plain.records] == \
        [rec_tuple(r) for r in traced.records]
    assert tracer.last(4)


# --------------------------------------------------------------------------
# telemetry column batches, env padding, the sharded sweep
# --------------------------------------------------------------------------
def test_complete_arrays_matches_completes_and_reference():
    names = ["u", "v", "w"]
    cols = dict(arrived_s=[0.0, 0.1, 0.2], started_s=[0.0, 0.2, 0.4],
                finished_s=[1.0, 0.9, 1.1], node=["n0", "n1", "n0"],
                node_id=[0, 1, 0], deadline_s=[None, 1.0, 0.5],
                energy_j=[5.0, 4.0, 3.0], split=[None, 3, 2],
                switches=[0, 1, 2], transfer_s=[0.0, 0.05, 0.1])
    a, b, r = psim.Telemetry(), psim.Telemetry(), rsim.Telemetry()
    for k in range(3):
        a.complete(psim.TaskRecord(
            name=names[k], **{key: v[k] for key, v in cols.items()}))
    b.complete_arrays(names, **cols)
    r.complete_arrays(names, **cols)
    assert len(b) == 3                   # pending counts before build
    b.complete(psim.TaskRecord("x", 2.0, 2.0, 3.0))   # after a batch
    a.complete(psim.TaskRecord("x", 2.0, 2.0, 3.0))
    r.complete(rsim.TaskRecord("x", 2.0, 2.0, 3.0))
    assert [rec_tuple(x) for x in a.records] \
        == [rec_tuple(x) for x in b.records] \
        == [rec_tuple(x) for x in r.records]
    assert a.summary() == b.summary() == r.summary()
    with pytest.raises(ValueError, match="node_id"):
        b.complete_arrays(["x"], [0.0], [0.0], [1.0], node=["n"],
                          node_id=[], deadline_s=[None], energy_j=[1.0])


def test_pad_envs_and_stack_envs():
    env = make_env(True, "fixed", 0)
    envs = env.snapshot([1e6, 2e6, 3e6])
    padded, e = pdec.pad_envs(envs, 4)
    assert (len(padded), e) == (4, 3)
    np.testing.assert_array_equal(padded.input_bytes.numpy(),
                                  [1e6, 2e6, 3e6, 3e6])
    same, e2 = pdec.pad_envs(envs, 3)
    assert same is envs and e2 == 3
    with pytest.raises(ValueError):
        pdec.pad_envs(envs, 0)
    offs = [(r_get(d), r_get("edge-server-a100"), bw, lat, ib)
            for d, bw, lat, ib in (("pi5-arm", 1e6, 0.01, 4e5),
                                   ("jetson-orin-nano", 3e7, 0.0, 0.0))]
    want = rdec.stack_envs([roff.OffloadEnv(*o) for o in offs])
    got = pdec.stack_envs([poff.OffloadEnv(p_get(o[0].name),
                                           p_get(o[1].name), *o[2:])
                           for o in offs], device=CPU)
    for g, w in zip(got.columns(), (want.dev_flops, want.edge_flops,
                                    want.link_bw, want.link_latency_s,
                                    want.input_bytes, want.dev_tdp_watts,
                                    want.edge_tdp_watts)):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(g.numpy(), w)
    assert pdec.BatchDecisions is pdec.DecisionPlan
    assert len(pdec.stack_envs([], device=CPU)) == 0


def test_decide_all_sharded_single_device_matches_reference_numpy():
    """On one device the sharded sweep is the exact f64 one, without a
    mesh and on a one-device mesh: bit for bit the reference's numpy
    ``decide_all``, with a ragged env count."""
    envs = make_env(True, "walk", 5).snapshot(np.linspace(1e5, 8e6, 13))
    renvs = make_env(False, "walk", 5).snapshot(np.linspace(1e5, 8e6, 13))
    want = rdec.decide_all(LAYERS[False], renvs)
    got = psim.decide_all_sharded(LAYERS[True], envs)
    for f in ("splits", "total_time_s", "device_time_s",
              "transfer_time_s", "edge_time_s"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    # a one-device mesh: a gloo group of world size 1
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import start_group
    with tempfile.TemporaryDirectory() as tmp:
        start_group("gloo", 0, 1, os.path.join(tmp, "store"))
        try:
            got = psim.decide_all_sharded(
                LAYERS[True], envs,
                mesh=init_device_mesh("cpu", (1,), mesh_dim_names=("data",)))
        finally:
            torch.distributed.destroy_process_group()
    for f in ("splits", "total_time_s", "device_time_s",
              "transfer_time_s", "edge_time_s"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="analytic cost only"):
        pfleet._split_decide(LAYERS[True], envs, object(), "sharded")


@pytest.mark.parametrize("engine", ["event", "fleet"])
def test_split_backend_sharded_matches_reference_numpy(engine):
    """decide-at-admission with ``split_backend="sharded"`` on either
    engine: the reference's records with ``"numpy"``."""
    runs = []
    for port in (False, True):
        sim, sch, specs, _, _, _ = PACKS[port]
        kw = {"device": CPU, "engine": engine,
              "split_backend": "sharded"} if port \
            else {"split_backend": "numpy"}
        links = make_links(sim, "walk", 3, 102)
        runs.append((sim.simulate_stream(
            make_tasks(sch, 10, seed=2, deadlines=True),
            make_arrivals(sim, "trace", 10, 2), make_nodes(sch, specs, 3),
            links=links, link_update_dt=0.5,
            split_env=make_env(port, "walk", 9),
            split_layers=LAYERS[port], **kw), links.values()))
    assert_bit_for_bit(runs)
    assert runs[1][0].counters["split_decides"] == 10


def test_kernel_split_backend_fleet_groups_match_event_admissions():
    """``split_backend="kernel"`` (its plain f32 twin here): the fleet
    engine's slab-batched decisions equal the event loop's E = 1 ones."""
    tels = []
    for engine in ("event", "fleet"):
        tels.append(psim.simulate_stream(
            make_tasks(psch, 40, seed=4, deadlines=True),
            make_arrivals(psim, "mmpp", 40, 4),
            make_nodes(psch, P_SPECS, 4),
            links=make_links(psim, "diurnal", 4, 8), link_update_dt=0.25,
            split_env=make_env(True, "walk", 6), split_layers=LAYERS[True],
            split_backend="kernel", engine=engine, device=CPU))
    assert [rec_tuple(r) for r in tels[0].records] == \
        [rec_tuple(r) for r in tels[1].records]
    assert tels[0].summary() == tels[1].summary()


# --------------------------------------------------------------------------
# fleet_scan's plain version and its dispatch
# --------------------------------------------------------------------------
def host_loop(avail, peak, rows, ts, fls, ibs, segs):
    """The reference's host loop for single-task batches
    (``repro/sim/fleet.py:463-476``), in numpy."""
    out = []
    for k in range(len(ts)):
        t = float(ts[k])
        etc = fls[k] / peak + ibs[k] / rows[segs[k]]
        fin = np.maximum(avail, t) + etc
        j = int(np.argmin(fin))
        start = float(np.maximum(avail[j], t))
        avail[j] = fin[j]
        out.append((j, start, float(fin[j]), float(etc[j])))
    return out


def scan_case(n_nodes, n, k, seed, ties):
    rng = np.random.default_rng(seed)
    peak = rng.uniform(1e10, 1e13, n_nodes)
    rows = rng.uniform(1e5, 1e8, (k, n_nodes))
    avail = rng.uniform(0, 2, n_nodes)
    if ties:                             # identical nodes: first index wins
        peak[:], rows[:], avail[:] = 1e12, 1e7, 0.0
    ts = np.sort(rng.uniform(0, 10, n))
    fls, ibs = rng.uniform(1e9, 5e11, n), rng.uniform(1e4, 1e7, n)
    segs = np.sort(rng.integers(0, k, n)).astype(np.int64)
    return avail, peak, rows, ts, fls, ibs, segs


@pytest.mark.parametrize("n_nodes,ties", [(1, False), (2, True), (33, False),
                                          (64, True), (300, False)])
def test_fleet_scan_plain_version_equals_host_loop(n_nodes, ties):
    avail, *rest = scan_case(n_nodes, 700, 5, n_nodes, ties)
    want = host_loop(avail.copy(), *rest)
    av = torch.tensor(avail)
    got = scan_ops.place_singletons(av, *(torch.tensor(a) for a in rest))
    assert got[0].dtype == torch.int64
    assert list(zip(*(g.tolist() for g in got))) == want
    end = avail.copy()
    host_loop(end, *rest)
    assert np.array_equal(av.numpy(), end)          # avail moved in place
    if ties:
        assert got[0][0].item() == 0


def test_fleet_scan_dispatch_and_kernel_checks():
    """CPU tensors take the plain version; the kernel wrapper takes CUDA
    tensors only, and checks types and shapes before building anything."""
    args = [torch.tensor(a) for a in scan_case(4, 10, 2, 0, False)]
    out = scan_ops.place_singletons(args[0].clone(), *args[1:])
    ref = scan_ref.place_singletons_ref(args[0].clone(), *args[1:])
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel.place_singletons_kernel(*args)
    assert scan_kernel.place_singletons_kernel.launches == 0
    empty = scan_ops.place_singletons(args[0].clone(), args[1], args[2],
                                      *(a[:0] for a in args[3:]))
    assert all(t.numel() == 0 for t in empty)


@pytest.mark.parametrize("n_nodes,route", [
    (1, "registers"), (31, "registers"), (32, "registers"),
    (33, "registers"), (256, "registers"), (257, "shared"),
    (scan_kernel.MAX_NODES, "shared")])
def test_fleet_scan_choose_route_by_nodes(n_nodes, route):
    """Avail in the consumer's registers up to 8 nodes a lane (256), in
    shared memory past it."""
    assert scan_kernel.choose_route(n_nodes) == route


def test_fleet_scan_kernel_refuses_routes_before_building():
    """An unknown route, and the registers route past 256 nodes,
    raise ValueError before the device is looked at or anything is built;
    the CPU's plain version counts no launch."""
    args = [torch.tensor(a) for a in scan_case(300, 10, 2, 0, False)]
    scan_kernel.reset_counts()
    with pytest.raises(ValueError, match="not one of"):
        scan_kernel.place_singletons_kernel(*args, route="warp")
    with pytest.raises(ValueError, match="at most 256"):
        scan_kernel.place_singletons_kernel(*args, route="registers")
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel.place_singletons_kernel(*args)
    with pytest.raises(ValueError, match="CUDA"):
        scan_kernel.place_singletons_kernel(*args, route="shared")
    scan_ops.place_singletons(args[0].clone(), *args[1:])
    assert scan_kernel.place_singletons_kernel.launches == 0
    assert scan_kernel.place_singletons_kernel.by_route == {
        "registers": 0, "shared": 0}
