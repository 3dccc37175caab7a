"""The port's streaming simulator against the JAX package's, on the CPU.

Arrival and link processes draw from the reference's numpy generators in
its order, and the event loop, the finish matrix and the telemetry are the
reference's host arithmetic, so everything is pinned bit for bit: arrival
times, link paths (scalar and batched steps), ``EnvArrays`` snapshots,
``StreamScheduler`` placements (at t = 0 equal to the batch schedules),
``simulate_stream`` records and ``summary()`` (static and drifting links,
rebalancing, a predictor cost, decide-at-admission with
``split_backend="torch"`` against the reference's ``"numpy"``), and each
option that came with the queueing, Pareto and fleet modules (pools, RTTs,
the split planner, its saturation hook, the fleet engine, the sharded
split backend) against the reference's run of it; ``Telemetry``'s obs
exports (registry rows, Prometheus text, attribution) against the
reference's on the same stream.
"""
import dataclasses
import json

import numpy as np
import pytest
from hypothesis_shim import given, settings, st

from repro import sim as rsim
from repro.core import costs as rco
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.core.predictors import GBTRegressor as RGBT
from repro.core.workloads import WorkloadConfig as RWorkload
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get
from repro.obs import Tracer

from repro_torch import sim as psim
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.core.predictors import GBTRegressor as PGBT
from repro_torch.core.workloads import WorkloadConfig as PWorkload
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get
from repro_torch.sim import fleet as pfleet

CPU = "cpu"
R_SPECS, P_SPECS = list(R_DEVICES.values()), list(P_DEVICES.values())


def make_tasks(sch, n, seed=3, deadlines=False):
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)),
                     deadline_s=float(rng.uniform(0.02, 2.0))
                     if deadlines else None)
            for i in range(n)]


def make_nodes(sch, specs, n=None):
    n = n or len(specs)
    return [sch.Node(specs[j % len(specs)]) for j in range(n)]


def record_tuples(tel):
    return [(r.name, r.node, r.node_id, r.arrived_s, r.started_s,
             r.finished_s, r.deadline_s, r.energy_j, r.split, r.switches,
             r.transfer_s) for r in tel.records]


def cnn_layers(off, workload):
    return off.workload_layer_costs(workload("cnn", 2, epochs=5,
                                             optimiser="adam", lr=1e-3,
                                             batch_size=32))


# --------------------------------------------------------------------------
# events
# --------------------------------------------------------------------------
def test_clock_and_event_queue():
    c = psim.Clock()
    assert c.advance(1.5) == 1.5
    assert c.advance_to(1.0) == 1.5
    assert c.advance_to(2.0) == 2.0
    with pytest.raises(ValueError):
        c.advance(-0.1)
    q = psim.EventQueue()
    q.push(2.0, "b")
    q.push(1.0, "a1")
    q.push_batch([1.0, 0.5], "c", ["x", "y"])
    q.push(1.0, "a2")
    assert q.peek_time() == 0.5
    assert [(e.kind, e.payload) for e in (q.pop() for _ in range(5))] == \
        [("c", "y"), ("a1", None), ("c", "x"), ("a2", None), ("b", None)]
    assert not q and q.peek_time() is None
    with pytest.raises(ValueError):
        q.push_batch([1.0], "z", [1, 2])


ARRIVALS = {
    "poisson_n": lambda m, s: m.poisson_arrivals(20.0, n=50, seed=s),
    "poisson_horizon": lambda m, s: m.poisson_arrivals(20.0, horizon=2.0,
                                                       seed=s, start=0.5),
    "mmpp": lambda m, s: m.mmpp_arrivals([5.0, 80.0], [0.5, 0.2],
                                         horizon=2.0, seed=s),
    "diurnal": lambda m, s: m.diurnal_arrivals(30.0, horizon=2.0,
                                               amplitude=0.8, period_s=1.0,
                                               seed=s),
    "seed_sequence": lambda m, s: m.poisson_arrivals(
        40.0, n=30, seed=np.random.SeedSequence(s).spawn(2)[1]),
}


@pytest.mark.parametrize("name", sorted(ARRIVALS))
def test_arrival_processes_match_reference(name):
    got = ARRIVALS[name](psim, 7)
    assert np.array_equal(got, ARRIVALS[name](rsim, 7))
    assert got.size > 0 and (np.diff(got) >= 0).all()


def test_arrival_validation():
    assert np.array_equal(psim.trace_arrivals([0.0, 1.0, 1.0, 2.5]),
                          [0.0, 1.0, 1.0, 2.5])
    for bad in ([1.0, 0.5], [-1.0, 0.5], [[0.0]]):
        with pytest.raises(ValueError):
            psim.trace_arrivals(bad)
    with pytest.raises(ValueError):
        psim.poisson_arrivals(1.0, seed=0)
    with pytest.raises(ValueError):
        psim.poisson_arrivals(1.0, n=5, horizon=1.0, seed=0)
    with pytest.raises(ValueError):
        psim.diurnal_arrivals(1.0, horizon=1.0, amplitude=2.0)
    assert (psim.poisson_arrivals(100.0, horizon=1.5, seed=0) < 1.5).all()
    assert (psim.diurnal_arrivals(50.0, horizon=1.0, seed=1) < 1.0).all()


# --------------------------------------------------------------------------
# state: link processes and snapshots
# --------------------------------------------------------------------------
LINKS = {
    "walk": lambda m: m.RandomWalkLink(1e8, sigma=1.0, min_bw=1e6,
                                       max_bw=1e9, seed=4),
    "walk_free": lambda m: m.RandomWalkLink(1e8, sigma=0.1, seed=5),
    "two_state": lambda m: m.TwoStateLink(1.25e9, 2e6, mean_good_s=0.5,
                                          mean_bad_s=0.5, seed=1),
    "diurnal": lambda m: m.DiurnalLink(1e8, amplitude=0.5, period_s=1.0,
                                       noise_sigma=0.2, seed=2),
    "fixed": lambda m: m.FixedLink(3e7),
}


@pytest.mark.parametrize("name", sorted(LINKS))
def test_link_paths_match_reference(name):
    """Scalar steps, then batched steps, then scalar again: the same path
    and the same generator state as the reference's."""
    r, p = LINKS[name](rsim), LINKS[name](psim)
    for dt in (0.5, 0.05, 0.0):
        assert [r.step(dt) for _ in range(20)] == \
            [p.step(dt) for _ in range(20)]
    assert np.array_equal(rsim.step_batch(r, 0.3, 64),
                          psim.step_batch(p, 0.3, 64))
    assert r.step(0.7) == p.step(0.7) and r.value == p.value
    assert psim.step_batch(p, 0.3, 0).shape == (0,)


def test_cluster_links_match_reference():
    bws = [s.link_bw for s in P_SPECS]
    for seed in (3, lambda: np.random.SeedSequence(9)):
        # a SeedSequence advances as it spawns: one fresh per package
        r = rsim.ClusterLinks.random_walk(
            bws, sigma=0.6, seed=seed() if callable(seed) else seed)
        p = psim.ClusterLinks.random_walk(
            bws, sigma=0.6, seed=seed() if callable(seed) else seed)
        assert np.array_equal(r.values(), p.values())
        assert np.array_equal(r.step(0.25), p.step(0.25))
        assert np.array_equal(r.step_batch(0.25, 16),
                              p.step_batch(0.25, 16))
    with pytest.raises(ValueError):
        psim.ClusterLinks([])


def test_drifting_env_snapshot_matches_reference():
    kw = dict(link_latency_s=0.005, input_bytes=4 * 32 * 784)
    r = rsim.DriftingEnv(r_get("pi5-arm"), r_get("edge-server-a100"),
                         rsim.RandomWalkLink(0.125e9, seed=1), **kw)
    p = psim.DriftingEnv(p_get("pi5-arm"), p_get("edge-server-a100"),
                         psim.RandomWalkLink(0.125e9, seed=1), **kw,
                         torch_device=CPU)
    for ib in (None, 1e5, [1e4, 2e6, 3e3]):
        a, b = r.snapshot(ib), p.snapshot(ib)
        for name, col in zip(("dev_flops", "edge_flops", "link_bw",
                              "link_latency_s", "input_bytes",
                              "dev_tdp_watts", "edge_tdp_watts"),
                             b.columns()):
            assert np.array_equal(getattr(a, name), col.numpy()), name
    assert p.snapshot(1e5) is p.snapshot(1e5)      # cached per input size
    snap = p.snapshot(1e5)
    assert r.step(1.0) == p.step(1.0)
    assert p.snapshot(1e5) is not snap             # link moved: refreshed
    assert np.array_equal(r.step_batch(0.5, 8), p.step_batch(0.5, 8))
    layers = cnn_layers(poff, PWorkload)
    plan = pdec.decide_all(layers, p.snapshot(), backend="torch",
                           device=CPU)
    scalar = poff.optimal_split(layers, poff.OffloadEnv(
        p.device, p.edge, p.link_bw, input_bytes=4 * 32 * 784))
    assert int(plan.splits[0]) == scalar.split


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------
def filled(m):
    tel = m.Telemetry()
    tel.complete(m.TaskRecord("a", 0.0, 0.5, 2.0, node="n0", node_id=0,
                              deadline_s=1.0, energy_j=3.0))
    tel.complete(m.TaskRecord("b", 0.0, 2.0, 3.0, node="n1", node_id=1))
    tel.complete(m.TaskRecord("c", 1.0, 2.0, 2.5, node="n0", node_id=0,
                              energy_j=1.0, split=3, switches=1,
                              transfer_s=0.1))
    tel.complete(m.TaskRecord("d", 1.5, 3.0, 4.0, node="n0", node_id=2,
                              deadline_s=3.5, energy_j=2.0))
    tel.complete(m.TaskRecord("e", 0.5, 4.0, 4.5, node="n1", node_id=1))
    tel.count("replans", 3)
    tel.gauge("oracle_nrmse", 0.25)
    return tel


def test_telemetry_matches_reference(tmp_path):
    r, p = filled(rsim), filled(psim)
    assert record_tuples(r) == record_tuples(p) and len(p) == 5
    assert r.summary() == p.summary()
    assert r.to_rows("unit") == p.to_rows("unit")
    assert r.utilisation() == p.utilisation()
    assert r.queue_lens() == p.queue_lens()
    assert r.cvar(0.9) == p.cvar(0.9)
    assert r.table() == p.table()
    p.save(str(tmp_path / "rows.json"), "unit")
    assert json.loads((tmp_path / "rows.json").read_text()) == \
        json.loads(json.dumps(r.to_rows("unit"), default=float))
    with pytest.raises(ValueError):
        p.cvar(1.0)


def test_utilisation_keeps_same_spec_nodes_apart():
    tel = psim.Telemetry()
    for nid in range(3):
        tel.complete(psim.TaskRecord(f"t{nid}", 0.0, 0.0, 10.0,
                                     node="xps15-i5", node_id=nid))
    assert tel.utilisation() == {"xps15-i5@0": 1.0, "xps15-i5@1": 1.0,
                                 "xps15-i5@2": 1.0}
    spec = p_get("xps15-i5")
    tel2 = psim.simulate_stream(make_tasks(psch, 12), np.zeros(12),
                                [psch.Node(spec) for _ in range(4)],
                                device=CPU)
    assert all(0.0 <= u <= 1.0 for u in tel2.utilisation().values())


#: each of Telemetry's obs exports, as the reference's test reads it
OBS_EXPORTS = {
    "registry": lambda tel: tel.registry("edge").to_rows("run"),
    "to_prometheus": lambda tel: tel.to_prometheus(),
    "attribution": lambda tel: (tel.attribution().summary(),
                                tel.attribution().miss_attribution()),
}


@pytest.mark.parametrize("method", sorted(OBS_EXPORTS))
def test_telemetry_obs_exports_match_reference(method):
    """``registry()``, ``to_prometheus()`` and ``attribution()`` of a port
    run equal the reference's on the same stream (pools, an RTT and
    deadlines, so every histogram and the miss classifier have data)."""
    tels = []
    for sim, sch, specs, kw in ((rsim, rsch, R_SPECS, {}),
                                (psim, psch, P_SPECS, {"device": CPU})):
        tels.append(sim.simulate_stream(
            make_tasks(sch, 40, deadlines=True),
            sim.poisson_arrivals(15.0, n=40, seed=5),
            make_nodes(sch, specs, 3), policy="min_min",
            pools=sim.NodePools.uniform(3, 1),
            rtt=sim.WeibullRTT(shape=0.7, scale=0.01, seed=14), **kw))
    want, got = (OBS_EXPORTS[method](t) for t in tels)
    assert got == want and got
    # the small filled run too
    assert OBS_EXPORTS[method](filled(psim)) == \
        OBS_EXPORTS[method](filled(rsim))


# --------------------------------------------------------------------------
# StreamScheduler
# --------------------------------------------------------------------------
def assignment_tuples(s):
    return [(a.task.name, a.node, a.start, a.finish) for a in s.assignments]


@pytest.mark.parametrize("policy,batch_fn", [("min_min", psch.min_min),
                                             ("heft", psch.heft)])
def test_stream_t0_static_matches_batch_and_reference(policy, batch_fn):
    tasks, nodes = make_tasks(psch, 23), make_nodes(psch, P_SPECS)
    batch = batch_fn(tasks, nodes, psch.etc_matrix(tasks, nodes))
    stream = psim.StreamScheduler(nodes, policy=policy, device=CPU)
    out = stream.run(tasks, np.zeros(len(tasks)))
    assert assignment_tuples(out) == assignment_tuples(batch)
    assert out.makespan == batch.makespan and stream.full_rebuilds == 0
    ref = rsim.StreamScheduler(make_nodes(rsch, R_SPECS), policy=policy)
    assert assignment_tuples(ref.run(make_tasks(rsch, 23),
                                     np.zeros(23))) == \
        assignment_tuples(out)


def test_stream_incremental_work_per_arrival():
    tasks, nodes = make_tasks(psch, 17), make_nodes(psch, P_SPECS)
    arr = psim.poisson_arrivals(50.0, n=len(tasks), seed=2)
    s = psim.StreamScheduler(nodes, device=CPU)
    out = s.run(tasks, arr)
    assert (s.rows_built, s.column_refreshes, s.full_rebuilds) == \
        (len(tasks), len(tasks), 0)
    r = rsim.StreamScheduler(make_nodes(rsch, R_SPECS))
    assert assignment_tuples(r.run(make_tasks(rsch, 17), arr)) == \
        assignment_tuples(out)
    starts = {a.task.name: a.start for a in out.assignments}
    assert all(starts[t.name] >= a for t, a in zip(tasks, arr))
    before = s.etc_rows(tasks[:1])[0]
    s.set_link_bw(0, 1.0)
    after = s.etc_rows(tasks[:1])[0]
    assert after[0] > before[0] * 100
    assert np.array_equal(after[1:], before[1:])
    with pytest.raises(ValueError):
        psim.StreamScheduler(nodes, policy="fifo", device=CPU)
    with pytest.raises(ValueError):
        psim.StreamScheduler(nodes, device=CPU).run(tasks[:3], [0.0, 1.0])


def test_rebalance_migrates_queue_tail_like_reference():
    def scenario(sim, sch, get):
        a100 = get("edge-server-a100")
        nodes = [sch.Node(dataclasses.replace(a100, name="n0")),
                 sch.Node(dataclasses.replace(a100, name="n1"))]
        kw = {"device": CPU} if sim is psim else {}
        s = sim.StreamScheduler(nodes, rebalance=True, **kw)
        (a_big,) = s.on_arrivals([sch.Task("big", flops=5e12,
                                           input_bytes=1e5)], 0.0)
        s.set_link_bw(0, 1.0)
        s.on_arrivals([sch.Task("q1", flops=5e12, input_bytes=1e5)], 0.01)
        (a_q2,) = s.on_arrivals([sch.Task("q2", flops=1e11,
                                          input_bytes=1e5)], 0.02)
        s.set_link_bw(0, a100.link_bw)
        old = a_q2.finish
        moved = s.on_node_free(0, now=a_big.finish)
        assert moved is a_q2 and s.node_index(a_q2) == 0
        assert a_q2.finish < old and s.migrations == 1
        assert s.on_node_free(0, now=a_q2.finish) is None
        return assignment_tuples(s.schedule()), s.etc_of(a_q2)
    assert scenario(psim, psch, p_get) == scenario(rsim, rsch, r_get)


# --------------------------------------------------------------------------
# simulate_stream against the reference
# --------------------------------------------------------------------------
def run_both(n_tasks, n_nodes, seed, **kw):
    """The same scenario through both packages; ``kw`` maps each keyword
    of ``simulate_stream`` to ``lambda sim_module, is_port -> value``."""
    out = []
    for sim, sch, specs, extra in ((rsim, rsch, R_SPECS, {}),
                                   (psim, psch, P_SPECS, {"device": CPU})):
        tasks = make_tasks(sch, n_tasks, seed=seed, deadlines=True)
        nodes = make_nodes(sch, specs, n_nodes)
        arrivals = sim.mmpp_arrivals([20.0, 200.0], [0.4, 0.1],
                                     horizon=2.0, seed=seed)[:n_tasks]
        tasks = tasks[:len(arrivals)]
        args = {k: v(sim, sim is psim) for k, v in kw.items()}
        out.append(sim.simulate_stream(tasks, arrivals, nodes, **args,
                                       **extra))
    return out


def links(sim, _):
    bws = [s.link_bw for s in (P_SPECS if sim is psim else R_SPECS)]
    return sim.ClusterLinks.random_walk(bws, sigma=0.5, seed=1)


SCENARIOS = {
    "static": {},
    "heft": {"policy": lambda s, p: "heft"},
    "links": {"links": links, "link_update_dt": lambda s, p: 0.1},
    "links_rebalance": {"links": links, "link_update_dt": lambda s, p: 0.25,
                        "rebalance": lambda s, p: True},
    "composite": {"cost": lambda s, p: (pco if p else rco).CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.05})},
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_simulate_stream_matches_reference(name):
    want, got = run_both(50, 7, 0, **SCENARIOS[name])
    assert len(got) > 0
    assert record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()
    for r in got.records:
        assert r.started_s >= r.arrived_s and r.finished_s > r.started_s


def test_simulate_stream_predictor_cost_matches_reference():
    def rows(off, co, specs):
        rng = np.random.default_rng(0)
        layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e12)),
                                act_bytes=0.0) for i in range(40)]
        return (np.concatenate([co.default_layer_features(layers, s)
                                for s in specs]),
                np.concatenate([[off.layer_time(lc.flops, s)
                                 for lc in layers] for s in specs]))
    r = RGBT(n_trees=25, max_depth=4).fit(*rows(roff, rco, R_SPECS))
    p = PGBT(n_trees=25, max_depth=4).fit(*rows(poff, pco, P_SPECS),
                                          device=CPU)

    def cost(sim, port):
        if port:
            return pco.PredictorCost(p, P_SPECS[2], P_SPECS[-1])
        return rco.PredictorCost(r, R_SPECS[2], R_SPECS[-1])

    want, got = run_both(40, 5, 4, cost=cost, links=links)
    assert record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(1, 14), st.integers(1, 5),
       st.booleans())
def test_no_task_starts_before_arrival_and_matches_reference(
        seed, n_tasks, n_nodes, rebalance):
    out = []
    for sim, sch, specs, kw in ((rsim, rsch, R_SPECS, {}),
                                (psim, psch, P_SPECS, {"device": CPU})):
        rng = np.random.default_rng(seed)
        nodes = make_nodes(sch, specs, n_nodes)
        arrivals = np.sort(rng.uniform(0.0, 2.0, size=n_tasks))
        links = sim.ClusterLinks.random_walk(
            [n.spec.link_bw for n in nodes], sigma=0.6, seed=seed)
        out.append(sim.simulate_stream(
            make_tasks(sch, n_tasks, seed=seed), arrivals, nodes,
            links=links, link_update_dt=0.25, rebalance=rebalance, **kw))
    assert record_tuples(out[0]) == record_tuples(out[1])
    assert len(out[1]) == n_tasks
    for r in out[1].records:
        assert r.finished_s > r.started_s >= r.arrived_s
        assert r.energy_j >= 0.0


def test_stream_deadline_misses_match_batch():
    tasks = make_tasks(psch, 25, deadlines=True)
    nodes = make_nodes(psch, P_SPECS)
    batch = psch.min_min(tasks, nodes, psch.etc_matrix(tasks, nodes))
    assert batch.deadline_misses() > 0
    tel = psim.simulate_stream(tasks, np.zeros(len(tasks)), nodes,
                               device=CPU)
    s = tel.summary()
    assert tel.deadline_misses == s["deadline_misses"] == \
        batch.deadline_misses()
    assert s["makespan_s"] == batch.makespan


def split_env(sim, port, seed=2):
    get = p_get if port else r_get
    extra = {"torch_device": CPU} if port else {}
    return sim.DriftingEnv(get("pi5-arm"), get("edge-server-a100"),
                           sim.RandomWalkLink(1.25e8, sigma=1.5,
                                              seed=seed),
                           input_bytes=1e5, **extra)


@pytest.mark.parametrize("split_cost", [None, "composite"])
def test_decide_at_admission_torch_matches_reference_numpy(split_cost):
    """Each admitted task's split, decided by ``decide_all`` on the
    snapshot of its arrival: the port's exact ``"torch"`` sweep equals the
    reference's ``"numpy"`` one, record for record."""
    w = {"latency_s": 1.0, "energy_j": 0.05}

    def cost(sim, port):
        if split_cost is None:
            return None
        return (pco if port else rco).CompositeCost(weights=w)

    kw = {"split_env": split_env,
          "split_layers": lambda sim, port: cnn_layers(
              poff if port else roff, PWorkload if port else RWorkload),
          "split_cost": cost, "link_update_dt": lambda s, p: 0.1,
          "split_backend": lambda s, p: "torch" if p else "numpy"}
    want, got = run_both(40, 5, 1, **kw)
    assert record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()
    assert got.summary()["split_decides"] == len(got)
    assert len({r.split for r in got.records}) > 1   # the link mattered


def test_decide_at_admission_kernel_route_is_near_optimal(monkeypatch):
    """``split_backend="kernel"`` (its plain f32 twin on the CPU): every
    admitted split within 1e-4 of the f64 optimum of its snapshot."""
    seen = []
    decide = pfleet._split_decide

    def recording(layers, envs, cost, backend):
        plan = decide(layers, envs, cost, backend)
        seen.append((envs, plan))
        return plan

    monkeypatch.setattr(pfleet, "_split_decide", recording)
    layers = cnn_layers(poff, PWorkload)
    tasks, nodes = make_tasks(psch, 30), make_nodes(psch, P_SPECS)
    arr = psim.poisson_arrivals(20.0, n=30, seed=3)
    tel = psim.simulate_stream(tasks, arr, nodes,
                               split_env=split_env(psim, True),
                               split_layers=layers, link_update_dt=0.1,
                               device=CPU)
    assert len(seen) == len(tel) == 30
    for envs, plan in seen:
        lat = pdec.latency_matrix(layers, envs)[0]
        chosen = lat[int(plan.splits[0])]
        assert chosen <= lat.min() * (1 + 1e-4) + 1e-12
    assert {r.split for r in tel.records} == \
        {int(p.splits[0]) for _, p in seen}


def test_traced_run_equals_untraced_and_dumps_on_failure(tmp_path,
                                                        monkeypatch):
    """A ``repro.obs`` tracer passed in (duck-typed) records the run
    without moving a number; on a crash the loop writes the flight
    recorder's post-mortem and re-raises."""
    tasks, nodes = make_tasks(psch, 20), make_nodes(psch, P_SPECS)
    arr = psim.poisson_arrivals(30.0, n=20, seed=5)
    plain = psim.simulate_stream(tasks, arr, nodes, device=CPU)
    tracer = Tracer()
    traced = psim.simulate_stream(tasks, arr, nodes, obs=tracer,
                                  device=CPU)
    assert record_tuples(plain) == record_tuples(traced)
    assert tracer.last(4)

    def broken(task, spec, etc_s, start_s):
        if start_s > 0.2:
            raise RuntimeError("planted")
        return etc_s

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="planted"):
        psim.simulate_stream(tasks, arr, nodes, obs=Tracer(),
                             service_time_fn=broken, device=CPU)
    dump = json.loads((tmp_path / "results" / "postmortem.json")
                      .read_text())
    assert dump["error"] == "RuntimeError: planted" and dump["n_events"] > 0


def queueing(port):
    from repro.sim import queueing as rq
    from repro_torch.sim import queueing as pq
    return pq if port else rq


def planner(sim, port):
    return sim.ParetoStreamScheduler(
        **({"torch_device": CPU} if port else {}))


#: nodes of the option runs: one per edge spec, as ``links`` builds them
N_OPT = len(P_SPECS)

#: each option the event loop gained with the queueing, Pareto and fleet
#: modules, run against the reference (the port's "sharded" split backend
#: against the reference's "numpy" one, the port's fleet engine against the
#: reference's event loop)
OPTIONS = {
    "pools": {"pools": lambda s, p: queueing(p).NodePools.uniform(N_OPT, 2)},
    "rtt": {"rtt": lambda s, p: queueing(p).WeibullRTT(shape=0.6,
                                                       scale=0.02, seed=3),
            "pools": lambda s, p: queueing(p).NodePools.uniform(N_OPT, None)},
    "split_planner": {"split_planner": planner, "split_env": split_env,
                      "split_layers": lambda s, p: cnn_layers(
                          poff if p else roff, PWorkload if p else RWorkload),
                      "link_update_dt": lambda s, p: 0.1},
    "saturation_threshold": {
        "split_planner": planner, "split_env": split_env,
        "split_layers": lambda s, p: cnn_layers(
            poff if p else roff, PWorkload if p else RWorkload),
        "pools": lambda s, p: queueing(p).NodePools.uniform(N_OPT, 1),
        "saturation_threshold": lambda s, p: 0.3},
    "fleet": {"links": links, "link_update_dt": lambda s, p: 0.1,
              "rtt": lambda s, p: queueing(p).WeibullRTT(seed=5)},
    "sharded": {"split_env": split_env,
                "split_layers": lambda s, p: cnn_layers(
                    poff if p else roff, PWorkload if p else RWorkload),
                "split_backend": lambda s, p: "sharded" if p else "numpy"},
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_option_runs_like_reference(option):
    """Every option of ``simulate_stream`` runs, record for record and
    summary for summary as the reference's run of it."""
    kw = dict(OPTIONS[option])
    if option == "fleet":
        kw["engine"] = lambda s, p: "fleet" if p else "event"
    want, got = run_both(50, N_OPT, 2, **kw)
    assert len(got) > 0
    assert record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()
