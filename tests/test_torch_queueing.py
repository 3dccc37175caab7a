"""The port's edge contention layer (``repro_torch.sim.queueing``) against the
JAX package's ``repro.sim.queueing``, on the CPU.

Pools are sequential host state and every process draws from the
reference's numpy generators in its order, so everything is pinned bit for
bit against the reference: ``ServerPool`` / ``NodePools`` state and
integrals, the RTT draws and closed forms, ``spawn_streams``, and
``simulate_stream`` records on both of the port's engines with pools, RTTs,
ground-truth service times and the saturation hook.  The closed forms are
held to the queueing-theory values and to Monte Carlo as the reference's
tests hold them, and the tail- and queue-aware cost stack's ``"torch"``
sweep equals the reference's ``"numpy"`` one bit for bit (its ``"kernel"``
route, the plain f32 twin here, within the reference's Pallas tolerance).
"""
import math

import numpy as np
import pytest
from hypothesis_shim import given, settings, st

from repro import sim as rsim
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get
from repro.sim import queueing as rq

from repro_torch import sim as psim
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get
from repro_torch.sim import queueing as pq

CPU = "cpu"
R_SPECS, P_SPECS = list(R_DEVICES.values()), list(P_DEVICES.values())


def make_tasks(sch, n, seed=3, deadlines=False):
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)),
                     deadline_s=float(rng.uniform(0.02, 2.0))
                     if deadlines else None)
            for i in range(n)]


def make_nodes(sch, specs, n):
    return [sch.Node(specs[j % len(specs)]) for j in range(n)]


def record_rows(tel):
    return [(r.name, r.arrived_s, r.started_s, r.finished_s, r.node,
             r.node_id, r.deadline_s, r.energy_j, r.transfer_s, r.split,
             r.switches) for r in tel.records]


# --------------------------------------------------------------------------
# ServerPool / NodePools units
# --------------------------------------------------------------------------
def test_pool_capacity1_is_scalar_avail():
    pool = pq.ServerPool(1)
    assert pool.admit(0.0, 2.0) == (0.0, 2.0)
    assert pool.admit(1.0, 3.0) == (2.0, 5.0)     # arrives while busy
    assert pool.wait(3.0) == 2.0 and pool.wait(6.0) == 0.0
    assert pool.next_free() == 5.0


def test_pool_fifo_tie_break_first_index():
    pool = pq.ServerPool(3)
    for _ in range(3):
        pool.admit(0.0, 1.0)
    assert np.array_equal(pool.busy, [1.0, 1.0, 1.0])
    assert pool.admit(0.5, 1.0) == (1.0, 2.0)     # first index wins
    assert np.array_equal(pool.busy, [2.0, 1.0, 1.0])


def test_pool_multiserver_wait():
    pool = pq.ServerPool(2)
    pool.admit(0.0, 4.0)
    pool.admit(0.0, 2.0)
    assert pool.wait(1.0) == 1.0 and pool.queue_len(1.0) == 2
    assert pool.admit(1.0, 1.0) == (2.0, 3.0)


def test_pool_infinite_capacity_never_waits():
    pool = pq.ServerPool(None)
    for k in range(3):
        s, _ = pool.admit(float(k) * 0.1, 5.0)
        assert s == float(k) * 0.1
    assert pool.wait(0.3) == 0.0
    assert pool.queue_len(0.25) == 3 and pool.queue_len(6.0) == 0


def test_pool_rejects_bad_capacity():
    with pytest.raises(ValueError):
        pq.ServerPool(0)


def test_pool_utilisation_and_queue_area():
    pool = pq.ServerPool(1)
    pool.admit(0.0, 1.0)
    assert pool.utilisation(2.0) == pytest.approx(0.5)
    pool2 = pq.ServerPool(1)
    for _ in range(3):
        pool2.admit(0.0, 2.0)                 # waits 0, 2, 4
    assert pool2.mean_queue_len(6.0) == pytest.approx(1.0)   # Little


@pytest.mark.parametrize("capacity", [1, 2, 3, None])
def test_pool_state_and_integrals_match_reference(capacity):
    """A random admission sequence through both pools: every (start,
    finish), wait, queue length, utilisation and queue integral equal."""
    rng = np.random.default_rng(capacity or 7)
    a, b = rq.ServerPool(capacity, 0.25), pq.ServerPool(capacity, 0.25)
    now = 0.0
    for _ in range(300):
        now += float(rng.exponential(0.4))
        svc = float(rng.exponential(1.0))
        assert a.admit(now, svc) == b.admit(now, svc)
        probe = now + float(rng.uniform(0, 2))
        assert a.wait(probe) == b.wait(probe)
        assert a.queue_len(probe) == b.queue_len(probe)
        assert a.next_free() == b.next_free()
    assert a.utilisation(now + 1.0) == b.utilisation(now + 1.0)
    assert a.mean_queue_len(now + 1.0) == b.mean_queue_len(now + 1.0)
    assert np.array_equal(a.busy, b.busy) and a.n_admitted == b.n_admitted


def test_nodepools_incremental_avail_matches_recompute_and_reference():
    rng = np.random.default_rng(0)
    caps = [int(c) for c in rng.integers(1, 4, 6)]
    a = rq.NodePools([rq.ServerPool(c) for c in caps])
    b = pq.NodePools([pq.ServerPool(c) for c in caps])
    for _ in range(200):
        j, now = int(rng.integers(6)), float(rng.uniform(0, 50))
        svc = float(rng.uniform(0.1, 3.0))
        assert a.admit(j, now, svc) == b.admit(j, now, svc)
        assert np.array_equal(b.avail, b.recompute_avail())
        assert np.array_equal(a.avail, b.avail)
    assert np.array_equal(a.waits(20.0), b.waits(20.0))
    assert np.array_equal(a.utilisation(60.0), b.utilisation(60.0))
    assert np.array_equal(a.saturated(60.0, 0.3), b.saturated(60.0, 0.3))
    assert len(pq.NodePools.uniform(4, None)) == 4


def test_nodepools_validations():
    nodes = make_nodes(psch, P_SPECS, 3)
    tasks = make_tasks(psch, 2)
    with pytest.raises(ValueError, match="2 pools for 3 nodes"):
        psim.simulate_stream(tasks, [0.0, 1.0], nodes,
                             pools=pq.NodePools.uniform(2, 1), device=CPU)
    with pytest.raises(ValueError, match="2 pools for 3 nodes"):
        psim.simulate_stream(tasks, [0.0, 1.0], nodes, engine="fleet",
                             pools=pq.NodePools.uniform(2, 1), device=CPU)
    with pytest.raises(ValueError, match="rebalance"):
        psim.simulate_stream(tasks, [0.0, 1.0], nodes[:2],
                             pools=pq.NodePools.uniform(2, 1),
                             rebalance=True, device=CPU)
    with pytest.raises(ValueError, match="rebalance"):
        psim.StreamScheduler(nodes[:2], pools=pq.NodePools.uniform(2, 1),
                             rebalance=True, device=CPU)


def test_scheduler_avail_is_the_pools_cache():
    """With pools the scheduler's availability vector is the pools' own
    ``avail`` array, updated in place on every admission."""
    pools = pq.NodePools.uniform(3, 2)
    s = psim.StreamScheduler(make_nodes(psch, P_SPECS, 3), pools=pools,
                             device=CPU)
    assert s.avail is pools.avail
    s.on_arrivals(make_tasks(psch, 7), 0.0)
    assert np.array_equal(pools.avail, pools.recompute_avail())
    assert sum(p.n_admitted for p in pools.pools) == 7


# --------------------------------------------------------------------------
# closed forms
# --------------------------------------------------------------------------
def test_erlang_c_known_values():
    assert pq.erlang_c(1, 0.5) == pytest.approx(0.5)
    assert pq.erlang_c(1, 0.0) == 0.0
    assert pq.erlang_c(2, 1.0) == pytest.approx(1.0 / 3.0)
    with pytest.raises(ValueError):
        pq.erlang_c(2, 2.0)
    with pytest.raises(ValueError):
        pq.erlang_c(0, 0.5)


def test_closed_forms_match_reference():
    for c in (1, 2, 3, 8):
        for a in (0.0, 0.3, 0.5 * c, 0.95 * c):
            assert pq.erlang_c(c, a) == rq.erlang_c(c, a)
        lam = 0.7 * c
        assert pq.mmc_sojourn(lam, 1.0, c) == rq.mmc_sojourn(lam, 1.0, c)
    assert pq.mm1_sojourn(0.5, 1.0) == rq.mm1_sojourn(0.5, 1.0)
    for p in (1e-6, 0.01, 0.02425, 0.3, 0.5, 0.9, 0.97575, 0.999):
        assert pq._norm_ppf(p) == rq._norm_ppf(p)
    with pytest.raises(ValueError):
        pq._norm_ppf(1.0)


def test_mm1_mmc_consistency():
    assert pq.mm1_sojourn(0.5, 1.0) == pytest.approx(2.0)
    assert pq.mmc_sojourn(0.5, 1.0, 1) == pytest.approx(
        pq.mm1_sojourn(0.5, 1.0))
    with pytest.raises(ValueError):
        pq.mm1_sojourn(1.0, 1.0)
    with pytest.raises(ValueError):
        pq.mmc_sojourn(3.0, 1.0, 2)


@pytest.mark.parametrize("kind", ["weibull", "lognormal"])
def test_rtt_closed_forms_match_monte_carlo(kind):
    proc = (pq.WeibullRTT(shape=0.7, scale=0.02, seed=5) if kind == "weibull"
            else pq.LognormalRTT(mu=-4.0, sigma=1.2, seed=5))
    x = proc.sample(400_000)
    assert proc.mean() == pytest.approx(float(x.mean()), rel=0.05)
    assert proc.percentile(0.99) == pytest.approx(
        float(np.percentile(x, 99)), rel=0.05)
    var = np.percentile(x, 99)
    assert proc.cvar(0.99) == pytest.approx(float(x[x >= var].mean()),
                                            rel=0.10)
    assert proc.tail_stat("p99", 0.5) == proc.percentile(0.99)
    assert proc.tail_stat("cvar", 0.95) == proc.cvar(0.95)
    with pytest.raises(ValueError):
        proc.tail_stat("p50", 0.5)


@pytest.mark.parametrize("kind", ["weibull", "lognormal"])
def test_rtt_draws_and_closed_forms_match_reference(kind):
    if kind == "weibull":
        make = {"shape": 0.6, "scale": 0.01}
        a, b = rq.WeibullRTT(seed=11, **make), pq.WeibullRTT(seed=11, **make)
    else:
        make = {"mu": -5.0, "sigma": 0.8}
        a, b = (rq.LognormalRTT(seed=11, **make),
                pq.LognormalRTT(seed=11, **make))
    assert np.array_equal(a.sample(64), b.sample(64))
    assert np.array_equal(a.sample(1), b.sample(1))
    assert a.mean() == b.mean()
    for q in (0.5, 0.9, 0.99):
        assert a.percentile(q) == b.percentile(q)
    for alpha in (0.9, 0.95, 0.99):
        assert a.cvar(alpha) == b.cvar(alpha)
    for tail in ("p99", "cvar"):
        assert a.tail_stat(tail, 0.95) == b.tail_stat(tail, 0.95)


def test_rtt_validation_and_heavy_tail_orders():
    w = pq.WeibullRTT(shape=0.6, scale=0.01, seed=0)
    assert w.mean() < w.percentile(0.99) < w.cvar(0.99)
    with pytest.raises(ValueError):
        pq.WeibullRTT(shape=0.0)
    with pytest.raises(ValueError):
        pq.LognormalRTT(sigma=0.0)
    with pytest.raises(ValueError):
        w.percentile(1.0)
    with pytest.raises(ValueError):
        w.cvar(1.0)


# --------------------------------------------------------------------------
# RNG hygiene
# --------------------------------------------------------------------------
def test_int_seed_replays_historical_stream():
    a = psim.poisson_arrivals(5.0, n=64, seed=7)
    b = psim.poisson_arrivals(5.0, n=64, seed=np.random.SeedSequence(7))
    assert np.array_equal(a, b)
    assert np.array_equal(a, rsim.poisson_arrivals(5.0, n=64, seed=7))
    w1 = pq.WeibullRTT(seed=3).sample(32)
    w2 = pq.WeibullRTT(seed=np.random.SeedSequence(3)).sample(32)
    assert np.array_equal(w1, w2)
    assert np.array_equal(w1, rq.WeibullRTT(seed=3).sample(32))


def test_spawn_streams_independent_and_equal_to_reference():
    kids = pq.spawn_streams(42, 3)
    assert len(kids) == 3
    draws = [np.random.default_rng(k).uniform(size=8) for k in kids]
    assert not np.array_equal(draws[0], draws[1])
    for seed in (42, np.random.SeedSequence(42)):
        again = [np.random.default_rng(k).uniform(size=8)
                 for k in rq.spawn_streams(seed, 3)]
        assert all(np.array_equal(a, b) for a, b in zip(draws, again))


def test_cluster_links_seedsequence_spawn():
    base = [40e6, 55e6, 70e6]
    a = psim.ClusterLinks.random_walk(base, sigma=0.4, seed=2)
    b = psim.ClusterLinks([psim.RandomWalkLink(bw, sigma=0.4, seed=2 + j)
                           for j, bw in enumerate(base)])
    for _ in range(5):
        assert np.array_equal(a.step(0.5), b.step(0.5))
    c = psim.ClusterLinks.random_walk(base, sigma=0.4,
                                      seed=np.random.SeedSequence(2))
    r = rsim.ClusterLinks.random_walk(base, sigma=0.4,
                                      seed=np.random.SeedSequence(2))
    vals = c.step(0.5)
    assert np.array_equal(vals, r.step(0.5))
    assert not np.array_equal(vals, a.values())


def test_run_seed_spawn_keeps_processes_independent():
    arr_ss, rtt_ss = pq.spawn_streams(123, 2)
    arr = psim.poisson_arrivals(5.0, n=32, seed=arr_ss)
    rtt = pq.WeibullRTT(seed=rtt_ss)
    assert np.array_equal(arr, psim.poisson_arrivals(
        5.0, n=32, seed=pq.spawn_streams(123, 2)[0]))
    assert rtt.sample(4).shape == (4,)


# --------------------------------------------------------------------------
# pools and RTTs through both engines, against the reference
# --------------------------------------------------------------------------
def run_three(n_tasks, n_nodes, seed, arrivals_fn, **kw):
    """The reference's event loop, then the port's event loop and fleet
    engine, on one scenario; ``kw`` maps each keyword to ``lambda is_port
    -> value`` (fresh stateful processes per run)."""
    out = []
    for port, engine in ((False, "event"), (True, "event"),
                         (True, "fleet")):
        sim, sch, specs = (psim, psch, P_SPECS) if port \
            else (rsim, rsch, R_SPECS)
        tasks = make_tasks(sch, n_tasks, seed=seed, deadlines=True)
        args = {k: v(port) for k, v in kw.items()}
        if port:
            args["device"] = CPU
        out.append(sim.simulate_stream(
            tasks, arrivals_fn(), make_nodes(sch, specs, n_nodes),
            engine=engine, **args))
    return out


def assert_all_equal(tels):
    want = record_rows(tels[0])
    for t in tels[1:]:
        assert record_rows(t) == want
        assert t.summary() == tels[0].summary()
        assert t.counters == tels[0].counters


def pools_of(n, capacity):
    return lambda port: (pq if port else rq).NodePools.uniform(n, capacity)


def rtt_of(seed, shape=0.7, scale=0.01):
    return lambda port: (pq if port else rq).WeibullRTT(
        shape=shape, scale=scale, seed=seed)


@pytest.mark.parametrize("engine", ["event", "fleet"])
@pytest.mark.parametrize("policy", ["min_min", "heft"])
def test_capacity1_bit_for_bit_with_historical(engine, policy):
    """capacity=1 pools with no service model reproduce the believed
    scalar queue, and both equal the reference's run with pools."""
    tasks = make_tasks(psch, 40, seed=11, deadlines=True)
    arr = np.sort(np.random.default_rng(1).uniform(0, 3.0, len(tasks)))
    kw = {"policy": policy, "engine": engine, "device": CPU}
    t0 = psim.simulate_stream(tasks, arr, make_nodes(psch, P_SPECS, 3),
                              **kw)
    t1 = psim.simulate_stream(tasks, arr, make_nodes(psch, P_SPECS, 3),
                              pools=pq.NodePools.uniform(3, 1), **kw)
    ref = rsim.simulate_stream(make_tasks(rsch, 40, seed=11,
                                          deadlines=True), arr,
                               make_nodes(rsch, R_SPECS, 3), policy=policy,
                               pools=rq.NodePools.uniform(3, 1))
    assert record_rows(t0) == record_rows(t1) == record_rows(ref)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(2, 12),
       st.integers(2, 4), st.booleans())
def test_zero_contention_infinite_capacity_bit_for_bit(
        seed, n_tasks, n_nodes, heft):
    """Arrivals spaced past every service time: capacity=∞ pools,
    capacity=1 pools and the believed queue agree on both engines."""
    rng = np.random.default_rng(seed)
    tasks = [psch.Task(f"t{i}", flops=float(rng.uniform(1e8, 5e9)),
                       input_bytes=float(rng.uniform(1e3, 1e5)))
             for i in range(n_tasks)]
    nodes = make_nodes(psch, P_SPECS, n_nodes)
    worst = max(psch.Node(n.spec).exec_time(t) for t in tasks for n in nodes)
    arrivals = np.arange(n_tasks, dtype=np.float64) * (worst * 1.01)
    policy = "heft" if heft else "min_min"
    base = [record_rows(psim.simulate_stream(
        tasks, arrivals, nodes, policy=policy, engine=e, device=CPU))
        for e in ("event", "fleet")]
    assert base[0] == base[1]
    for cap in (None, 1):
        for e, ref in zip(("event", "fleet"), base):
            got = record_rows(psim.simulate_stream(
                tasks, arrivals, nodes, policy=policy,
                pools=pq.NodePools.uniform(n_nodes, cap), engine=e,
                device=CPU))
            assert got == ref


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 30), st.integers(2, 4),
       st.sampled_from(["min_min", "heft"]),
       st.sampled_from([1, 2, None]), st.booleans(), st.booleans())
def test_event_fleet_equivalent_under_contention(
        seed, n_tasks, n_nodes, policy, capacity, with_rtt, ground_truth):
    """Pools (with RTTs and a ground-truth service model drawn at
    admission) on the port's two engines, against the reference."""
    rng = np.random.default_rng(seed)
    arrivals = np.sort(rng.uniform(0, 2.0, n_tasks))
    kw = {"policy": lambda p: policy, "pools": pools_of(n_nodes, capacity)}
    if with_rtt:
        kw["rtt"] = rtt_of(seed % 97)
    if ground_truth:
        kw["service_time_fn"] = lambda p: (
            lambda task, spec, etc, start: etc * (
                1.1 + 0.2 * math.sin(start + task.flops * 1e-12)))
    assert_all_equal(run_three(n_tasks, n_nodes, seed % 1000,
                               lambda: arrivals, **kw))


def test_contention_inflates_sojourn_and_telemetry():
    tels = run_three(60, 2, 2, lambda: np.zeros(60),
                     pools=pools_of(2, 1))
    assert_all_equal(tels)
    tel = tels[2]
    s = tel.summary()
    assert s["p99_wait_s"] > 0.0 and s["mean_wait_s"] > 0.0
    assert s["mean_queue_len"] > 0.0
    for r in tel.records:
        assert r.sojourn_s == pytest.approx(r.wait_s + r.service_s
                                            + r.transfer_s)
    assert sum(tel.queue_lens().values()) == pytest.approx(
        s["mean_queue_len"])


def test_rtt_recorded_as_transfer():
    """One RTT draw per task, booked as ``transfer_s``: the same draws in
    the same order as the reference, on both engines."""
    tels = run_three(10, 2, 4, lambda: np.linspace(0, 5, 10),
                     pools=pools_of(2, 1), rtt=rtt_of(9, 0.7, 0.01))
    assert_all_equal(tels)
    assert all(r.transfer_s > 0.0 for r in tels[1].records)
    assert all(r.finished_s > r.started_s for r in tels[2].records)


def test_rtt_without_pools_and_with_links_matches_reference():
    def links(port):
        sim = psim if port else rsim
        return sim.ClusterLinks.random_walk([40e6, 55e6, 70e6], sigma=0.5,
                                            seed=3)
    tels = run_three(40, 3, 6, lambda: rsim.poisson_arrivals(
        12.0, n=40, seed=6), rtt=rtt_of(5, 0.6, 0.05), links=links,
        link_update_dt=lambda p: 0.25)
    assert_all_equal(tels)


def test_pools_with_ground_truth_service_are_drawn_at_admission():
    seen = []

    def truth(port):
        def fn(task, spec, etc, start):
            if port:
                seen.append(start)
            return etc * 1.5
        return fn
    tels = run_three(30, 3, 8, lambda: np.sort(
        np.random.default_rng(8).uniform(0, 1.0, 30)),
        pools=pools_of(3, 2), service_time_fn=truth)
    assert_all_equal(tels)
    assert len(seen) == 60                       # once a task, per engine


def split_env(sim, port, seed=4):
    get = p_get if port else r_get
    extra = {"torch_device": CPU} if port else {}
    return sim.DriftingEnv(get("jetson-orin-nano"), get("edge-server-a100"),
                           sim.RandomWalkLink(30e6, sigma=0.3, seed=seed),
                           link_latency_s=0.005, **extra)


def five_layers(off):
    return [off.LayerCost(f"l{i}", flops=2e8 * (i + 1),
                          act_bytes=1e5 * (i + 1)) for i in range(5)]


def test_saturation_hook_fires_like_reference_and_fleet_rejects():
    tels, planners = [], []
    for port in (False, True):
        sim, sch, specs, off = (psim, psch, P_SPECS, poff) if port \
            else (rsim, rsch, R_SPECS, roff)
        planner = sim.ParetoStreamScheduler(
            **({"torch_device": CPU} if port else {}))
        kw = {"device": CPU} if port else {}
        tels.append(sim.simulate_stream(
            make_tasks(sch, 60, seed=1, deadlines=True),
            np.sort(np.random.default_rng(0).uniform(0, 0.4, 60)),
            make_nodes(sch, specs, 3), split_planner=planner,
            split_env=split_env(sim, port), split_layers=five_layers(off),
            link_update_dt=0.5, pools=sim.NodePools.uniform(3, 1),
            saturation_threshold=0.5, **kw))
        planners.append(planner)
    assert record_rows(tels[0]) == record_rows(tels[1])
    assert tels[0].summary() == tels[1].summary()
    assert tels[1].summary().get("split_saturation_repicks", 0) >= 1
    assert planners[1].total_repicks == planners[0].total_repicks
    tasks = make_tasks(psch, 60, seed=1, deadlines=True)
    arr = np.sort(np.random.default_rng(0).uniform(0, 0.4, 60))
    with pytest.raises(ValueError, match="saturation_threshold"):
        psim.simulate_stream(tasks, arr, make_nodes(psch, P_SPECS, 3),
                             split_planner=psim.ParetoStreamScheduler(
                                 torch_device=CPU),
                             split_env=split_env(psim, True),
                             split_layers=five_layers(poff),
                             pools=pq.NodePools.uniform(3, 1),
                             saturation_threshold=0.5, engine="fleet",
                             device=CPU)
    with pytest.raises(ValueError, match="saturation_threshold"):
        psim.simulate_stream(tasks, arr, make_nodes(psch, P_SPECS, 3),
                             pools=pq.NodePools.uniform(3, 1),
                             saturation_threshold=0.5, device=CPU)


def test_oracle_sees_the_rtt_as_extra_transfer():
    """With ``rtt=`` the event loop hands each sampled RTT to the oracle as
    extra transfer, as the reference does (the refit target nets it out)."""
    seen = []

    class Recorder:
        telemetry = obs = None

        class registry:
            obs = None

        def cost_model(self):
            return pco.AnalyticCost()

        def observe_task(self, task, spec, **kw):
            seen.append(kw["extra_transfer_s"])

    tel = psim.simulate_stream(make_tasks(psch, 12, seed=2),
                               np.linspace(0, 2, 12),
                               make_nodes(psch, P_SPECS, 2),
                               oracle=Recorder(), rtt=pq.WeibullRTT(seed=4),
                               device=CPU)
    assert sorted(seen) == sorted(r.transfer_s for r in tel.records)
    assert all(x > 0.0 for x in seen)


# --------------------------------------------------------------------------
# tail- and queue-aware costs: the port's torch sweep against numpy
# --------------------------------------------------------------------------
def rand_layers(off, rng, n):
    return [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e6, 1e12)),
                          act_bytes=float(rng.uniform(1e2, 1e8)))
            for i in range(n)]


def rand_envs(port, seed, n):
    rng = np.random.default_rng(seed)
    specs = P_SPECS if port else R_SPECS
    args = ([specs[int(rng.integers(len(specs)))] for _ in range(n)],
            specs[int(rng.integers(len(specs)))])
    kw = dict(link_bw=rng.uniform(1e4, 1e10, n),
              link_latency_s=rng.uniform(0.0, 0.05, n),
              input_bytes=rng.uniform(0.0, 1e7, n))
    if port:
        return pdec.make_envs(*args, device=CPU, **kw)
    return rdec.make_envs(*args, **kw)


def tail_cost(port, tail):
    co, q = (pco, pq) if port else (rco, rq)
    return co.CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.05, "price": 1.0,
                 "tail_latency_s": 0.5},
        price_per_edge_s=0.1, price_per_gb=0.01, deadline_s=0.05,
        tail=tail, tail_alpha=0.95,
        rtt=q.WeibullRTT(shape=0.7, scale=0.02, seed=0))


def assert_plan_equals_reference(got, want):
    for f in ("splits", "total_time_s", "device_time_s",
              "transfer_time_s", "edge_time_s"):
        assert np.array_equal(getattr(got, f).numpy(),
                              np.asarray(getattr(want, f))), f
    assert got.objectives == want.objectives
    for f in ("components", "scalar_cost"):
        x, y = getattr(got, f), getattr(want, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.array_equal(x.numpy(), np.asarray(y)), f


def test_tail_objective_grows_component_column():
    cost = tail_cost(True, "p99")
    assert cost.objectives == ("latency_s", "energy_j", "price",
                               "deadline_slack_s", "tail_latency_s")
    assert pco.CompositeCost().objectives == (
        "latency_s", "energy_j", "price", "deadline_slack_s")
    rng = np.random.default_rng(0)
    layers, envs = rand_layers(poff, rng, 6), rand_envs(True, 1, 4)
    plan = pdec.decide_all(layers, envs, cost=cost, backend="torch",
                           device=CPU)
    assert tuple(plan.components.shape) == (4, 5)
    assert cost.tail_excess_s() == tail_cost(False, "p99").tail_excess_s()
    comp = cost.components(layers, envs).numpy()
    assert np.array_equal(comp[..., :-1, 4],
                          comp[..., :-1, 0] + cost.tail_excess_s())
    assert np.array_equal(comp[..., -1, 4], comp[..., -1, 0])


def test_tail_requires_rtt():
    with pytest.raises(ValueError, match="rtt"):
        pco.CompositeCost(tail="p99")
    with pytest.raises(ValueError, match="tail"):
        pco.CompositeCost(tail="p42", rtt=pq.WeibullRTT(seed=0))


@pytest.mark.parametrize("tail", ["p99", "cvar"])
def test_tail_cost_torch_matches_reference_numpy(tail):
    layers_p = rand_layers(poff, np.random.default_rng(17), 12)
    layers_r = rand_layers(roff, np.random.default_rng(17), 12)
    got = pdec.decide_all(layers_p, rand_envs(True, 9, 9),
                          cost=tail_cost(True, tail), backend="torch",
                          device=CPU)
    want = rdec.decide_all(layers_r, rand_envs(False, 9, 9),
                           cost=tail_cost(False, tail), backend="numpy")
    assert_plan_equals_reference(got, want)


def test_queue_aware_cost_bumps_latency_only():
    rng = np.random.default_rng(5)
    layers, envs = rand_layers(poff, rng, 8), rand_envs(True, 5, 5)
    base = pco.CompositeCost(weights={"latency_s": 1.0, "energy_j": 0.1},
                             deadline_s=0.05)
    qa = pco.QueueAwareCost(base=base, wait_s=0.25)
    c0 = base.components(layers, envs).numpy()
    c1 = qa.components(layers, envs).numpy()
    assert np.array_equal(c1[..., :-1, 0], c0[..., :-1, 0] + 0.25)
    assert np.array_equal(c1[..., -1, 0], c0[..., -1, 0])
    assert np.array_equal(c1[..., 1:], c0[..., 1:])


def test_queue_aware_cost_live_pool_state():
    out = []
    for co, q in ((pco, pq), (rco, rq)):
        pool = q.ServerPool(1)
        pool.admit(0.0, 3.0)                 # busy until 3.0
        qa = co.QueueAwareCost(base=co.AnalyticCost(), edge_pool=pool,
                               rtt=q.LognormalRTT(mu=-5.0, sigma=0.5,
                                                  seed=0))
        qa.set_now(1.0)
        w1 = qa._edge_wait()
        assert w1 == pytest.approx(2.0 + qa.rtt.mean())
        qa.set_now(5.0)                      # drained
        assert qa._edge_wait() == pytest.approx(qa.rtt.mean())
        out.append((w1, qa._edge_wait(), qa.accel_spec().queue_wait_s))
    assert out[0] == out[1]


@pytest.mark.parametrize("tail", [None, "p99"])
def test_queue_aware_cost_torch_matches_reference_numpy(tail):
    plans = []
    for port in (True, False):
        co, dec, off = (pco, pdec, poff) if port else (rco, rdec, roff)
        q = pq if port else rq
        base = tail_cost(port, tail) if tail else co.CompositeCost(
            weights={"latency_s": 1.0, "energy_j": 0.05, "price": 1.0},
            price_per_edge_s=0.1, price_per_gb=0.01, deadline_s=0.05)
        pool = q.ServerPool(2)
        pool.admit(0.0, 0.3)
        pool.admit(0.0, 0.2)
        qa = co.QueueAwareCost(base=base, edge_pool=pool, wait_s=0.1)
        qa.set_now(0.05)
        layers = rand_layers(off, np.random.default_rng(23), 10)
        kw = {"backend": "torch", "device": CPU} if port \
            else {"backend": "numpy"}
        plans.append(dec.decide_all(layers, rand_envs(port, 23, 7),
                                    cost=qa, **kw))
    assert_plan_equals_reference(*plans)


def test_queue_aware_cost_kernel_route_close_to_reference():
    """The ``decide_split`` route (its plain f32 twin on CPU tensors) with
    the queue-wait and tail terms live: the reference's numpy splits, and
    its times within the reference's Pallas tolerance."""
    plans = []
    for port in (True, False):
        co, dec, off = (pco, pdec, poff) if port else (rco, rdec, roff)
        qa = co.QueueAwareCost(base=tail_cost(port, "p99"), wait_s=0.05)
        layers = rand_layers(off, np.random.default_rng(31), 9)
        kw = {"backend": "kernel", "device": CPU} if port \
            else {"backend": "numpy"}
        plans.append(dec.decide_all(layers, rand_envs(port, 31, 6),
                                    cost=qa, **kw))
    got, ref = plans
    assert np.array_equal(got.splits.numpy(), ref.splits)
    for f in ("total_time_s", "device_time_s", "transfer_time_s",
              "edge_time_s"):
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(ref, f),
                                   rtol=1e-5, atol=1e-7)


def test_queue_aware_task_matrix_adds_node_waits():
    pools = pq.NodePools.uniform(3, 1)
    pools.admit(1, 0.0, 4.0)                 # node 1 backlogged
    qa = pco.QueueAwareCost(base=pco.AnalyticCost(), pools=pools)
    qa.set_now(1.0)
    tasks, nodes = make_tasks(psch, 4, seed=0), make_nodes(psch, P_SPECS, 3)
    base_etc = psch.etc_matrix(tasks, nodes, cost=pco.AnalyticCost(),
                               device=CPU)
    etc = psch.etc_matrix(tasks, nodes, cost=qa, device=CPU)
    extra = np.asarray(etc) - np.asarray(base_etc)
    assert np.allclose(extra[:, 1], 3.0)
    assert np.allclose(extra[:, [0, 2]], 0.0)
    rpools = rq.NodePools.uniform(3, 1)
    rpools.admit(1, 0.0, 4.0)
    rqa = rco.QueueAwareCost(base=rco.AnalyticCost(), pools=rpools)
    rqa.set_now(1.0)
    want = rsch.etc_matrix(make_tasks(rsch, 4, seed=0),
                           make_nodes(rsch, R_SPECS, 3), cost=rqa)
    assert np.array_equal(etc, want)


# --------------------------------------------------------------------------
# validation: M/M/1 and M/M/c against the closed forms
# --------------------------------------------------------------------------
def _sim_mmc_pool(lam, mu, c, n, seed):
    arr_ss, svc_ss = pq.spawn_streams(seed, 2)
    arr = np.cumsum(np.random.default_rng(arr_ss).exponential(1.0 / lam, n))
    svc = np.random.default_rng(svc_ss).exponential(1.0 / mu, n)
    pool = pq.ServerPool(c)
    soj = np.empty(n)
    for i in range(n):
        start, fin = pool.admit(arr[i], svc[i])
        soj[i] = fin - arr[i]
        assert start >= arr[i]
    return float(soj.mean())


@pytest.mark.parametrize("rho,tol", [(0.3, 0.05), (0.7, 0.05),
                                     (0.9, 0.12)])
@pytest.mark.parametrize("c", [1, 3])
def test_mmc_sojourn_matches_erlang_c(rho, tol, c):
    lam = rho * c
    want = pq.mm1_sojourn(lam, 1.0) if c == 1 \
        else pq.mmc_sojourn(lam, 1.0, c)
    assert _sim_mmc_pool(lam, 1.0, c, 40_000, seed=0) == pytest.approx(
        want, rel=tol)


def test_mm1_through_simulator():
    """End-to-end M/M/1 through the port's event loop: Poisson arrivals,
    exponential ground-truth service drawn at admission — the sojourns
    match 1/(mu - lambda), and the records the reference's."""
    mu, rho, n = 2.0, 0.7, 12_000
    lam = rho * mu
    tels = []
    for sim, sch, specs, kw in ((psim, psch, P_SPECS, {"device": CPU}),
                                (rsim, rsch, R_SPECS, {})):
        arr_ss, svc_ss = (pq if sim is psim else rq).spawn_streams(7, 2)
        svc_rng = np.random.default_rng(svc_ss)
        tels.append(sim.simulate_stream(
            [sch.Task(f"t{i}", flops=1e9, input_bytes=0.0)
             for i in range(n)],
            sim.poisson_arrivals(lam, n=n, seed=arr_ss),
            make_nodes(sch, specs, 1), pools=sim.NodePools.uniform(1, 1),
            service_time_fn=lambda task, spec, etc_s, start_s, r=svc_rng:
            float(r.exponential(1.0 / mu)), **kw))
    assert record_rows(tels[0]) == record_rows(tels[1])
    soj = np.asarray([r.sojourn_s for r in tels[0].records])
    assert float(soj.mean()) == pytest.approx(pq.mm1_sojourn(lam, mu),
                                              rel=0.08)
    assert tels[0].summary()["mean_wait_s"] == pytest.approx(
        float(soj.mean()) - 1.0 / mu, rel=0.12)
