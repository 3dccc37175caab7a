"""The port's offloading policies, scheduler and PO-MDP against the JAX
package's, on the CPU.

Host code in both packages, the same arithmetic in the same order, so
everything here is pinned bit for bit: the split policies and the
Q-learning table (``core.offload``), the ETC matrices of every cost seam
(analytic, ``CompositeCost``, ``PredictorCost.task_matrix`` over a GBT
that both packages grow identically, ``QueueAwareCost`` with ``pools=``),
the batch schedules of every heuristic and its ``_ref`` oracle, the MDP
value and the PO-MDP makespans.
"""
import dataclasses

import numpy as np
import pytest
from hypothesis_shim import given, settings, st

from repro.core import costs as rco
from repro.core import offload as roff
from repro.core import pomdp as rpomdp
from repro.core import scheduler as rsch
from repro.core.predictors import GBTRegressor as RGBT
from repro.core.workloads import WorkloadConfig as RWorkload
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get

from repro_torch.core import costs as pco
from repro_torch.core import offload as poff
from repro_torch.core import pomdp as ppomdp
from repro_torch.core import scheduler as psch
from repro_torch.core.predictors import GBTRegressor as PGBT
from repro_torch.core.workloads import WorkloadConfig as PWorkload
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get

CPU = "cpu"
R_SPECS, P_SPECS = list(R_DEVICES.values()), list(P_DEVICES.values())


def envs_pair(link_bw=0.125e9, input_bytes=4 * 32 * 784):
    return (roff.OffloadEnv(r_get("pi5-arm"), r_get("edge-server-a100"),
                            link_bw=link_bw, input_bytes=input_bytes),
            poff.OffloadEnv(p_get("pi5-arm"), p_get("edge-server-a100"),
                            link_bw=link_bw, input_bytes=input_bytes))


@pytest.fixture(scope="module")
def cnn_layers():
    kw = dict(epochs=5, optimiser="adam", lr=1e-3, batch_size=32)
    return (roff.workload_layer_costs(RWorkload("cnn", 2, **kw)),
            poff.workload_layer_costs(PWorkload("cnn", 2, **kw)))


def as_tuple(d):
    return (d.split, d.total_time_s, d.device_time_s, d.transfer_time_s,
            d.edge_time_s)


# --------------------------------------------------------------------------
# core.offload
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind,ti", [("cnn", 0), ("cnn", 2), ("mlp", 0),
                                     ("mlp", 2)])
def test_workload_layer_costs_match_reference(kind, ti):
    kw = dict(epochs=5, optimiser="adam", lr=1e-3, batch_size=32)
    bs = 16 if kind == "mlp" else None
    r = roff.workload_layer_costs(RWorkload(kind, ti, **kw), batch_size=bs)
    p = poff.workload_layer_costs(PWorkload(kind, ti, **kw), batch_size=bs)
    assert [dataclasses.astuple(x) for x in r] == \
        [dataclasses.astuple(x) for x in p]


@pytest.mark.parametrize("link_bw", [1e4, 0.125e9, 12.5e9])
def test_split_policies_match_reference(cnn_layers, link_bw):
    rl, pl = cnn_layers
    re, pe = envs_pair(link_bw)
    assert np.array_equal(roff.split_times_all(rl, re),
                          poff.split_times_all(pl, pe))
    for a, b in zip(roff.split_components(rl, re),
                    poff.split_components(pl, pe)):
        assert np.array_equal(a, b)
    assert np.array_equal(roff.layer_time_vector(rl, re.edge),
                          poff.layer_time_vector(pl, pe.edge))
    for name in ("optimal_split", "optimal_split_ref", "greedy_split",
                 "greedy_split_ref", "local_only", "remote_only"):
        assert as_tuple(getattr(roff, name)(rl, re)) == \
            as_tuple(getattr(poff, name)(pl, pe)), name
    for s in (0, 3, len(pl)):
        assert as_tuple(roff.split_time(rl, s, re)) == \
            as_tuple(poff.split_time(pl, s, pe))


def test_split_policies_with_time_fn(cnn_layers):
    rl, pl = cnn_layers
    re, pe = envs_pair()

    def fn(lc, dev):
        return lc.flops / dev.peak_flops + lc.param_bytes / dev.hbm_bw

    assert as_tuple(roff.optimal_split(rl, re, time_fn=fn)) == \
        as_tuple(poff.optimal_split(pl, pe, time_fn=fn))
    assert as_tuple(roff.greedy_split_ref(rl, re, time_fn=fn)) == \
        as_tuple(poff.greedy_split_ref(pl, pe, time_fn=fn))


def test_fast_link_prefers_edge(cnn_layers):
    pl = cnn_layers[1]
    fast, slow = envs_pair(12.5e9)[1], envs_pair(1e4)[1]
    assert poff.optimal_split(pl, fast).split == 0
    assert poff.optimal_split(pl, slow).split == len(pl)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.floats(1e6, 1e12), st.floats(1e2, 1e8)),
                min_size=1, max_size=12),
       st.floats(1e5, 1e10))
def test_optimal_split_is_global_minimum(layer_spec, link_bw):
    layers = [poff.LayerCost(f"l{i}", flops=f, act_bytes=a)
              for i, (f, a) in enumerate(layer_spec)]
    env = envs_pair(link_bw)[1]
    best = poff.optimal_split(layers, env)
    for s in range(len(layers) + 1):
        assert best.total_time_s <= poff.split_time(layers, s,
                                                    env).total_time_s + 1e-12


@pytest.mark.parametrize("episodes,seed", [(4000, 1), (500, 7)])
def test_qlearning_q_table_matches_reference(cnn_layers, episodes, seed):
    rl, pl = cnn_layers
    re, pe = envs_pair()
    r = roff.QLearningPolicy(rl, re, episodes=episodes, seed=seed).train()
    p = poff.QLearningPolicy(pl, pe, episodes=episodes, seed=seed).train()
    assert np.array_equal(r.q_, p.q_)
    assert r.regret() == p.regret()
    assert as_tuple(r.decide(3e7)) == as_tuple(p.decide(3e7))
    if episodes == 4000:
        assert p.regret() < 0.05 * poff.local_only(pl, pe).total_time_s \
            + 1e-9


# --------------------------------------------------------------------------
# ETC matrices from every cost seam
# --------------------------------------------------------------------------
def cluster(sch, specs, n_tasks=12, seed=3, deadlines=False):
    rng = np.random.default_rng(seed)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e7)),
                      deadline_s=float(rng.uniform(0.02, 2.0))
                      if deadlines else None)
             for i in range(n_tasks)]
    return tasks, [sch.Node(s) for s in specs]


@pytest.fixture(scope="module")
def clusters():
    return cluster(rsch, R_SPECS), cluster(psch, P_SPECS)


@pytest.fixture(scope="module")
def gbts():
    """A GBT per package on per-layer rows: the same trees."""
    def rows(off, co, specs):
        rng = np.random.default_rng(0)
        layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e12)),
                                act_bytes=0.0) for i in range(40)]
        return (np.concatenate([co.default_layer_features(layers, s)
                                for s in specs]),
                np.concatenate([[off.layer_time(lc.flops, s)
                                 for lc in layers] for s in specs]))
    (rx, ry), (px, py) = rows(roff, rco, R_SPECS), rows(poff, pco, P_SPECS)
    return (RGBT(n_trees=25, max_depth=4).fit(rx, ry),
            PGBT(n_trees=25, max_depth=4).fit(px, py, device=CPU))


class Pools:
    """Duck-typed node pools: ``waits(now) -> [N]``."""

    def __init__(self, n):
        self.base = np.linspace(0.0, 0.3, n)

    def waits(self, now):
        return self.base + 0.01 * now


def cost_pairs(gbts):
    r, p = gbts
    rp = rco.PredictorCost(r, R_SPECS[2], R_SPECS[-1])
    pp = pco.PredictorCost(p, P_SPECS[2], P_SPECS[-1])
    w = {"latency_s": 1.0, "energy_j": 0.05, "price": 1.0}
    return {
        "analytic": (rco.AnalyticCost(), pco.AnalyticCost()),
        "composite": (rco.CompositeCost(weights=w, price_per_edge_s=0.1),
                      pco.CompositeCost(weights=w, price_per_edge_s=0.1)),
        "predictor": (rp, pp),
        "queue_pools": (
            rco.QueueAwareCost(base=rp, pools=Pools(5), wait_s=0.02,
                               now=3.0),
            pco.QueueAwareCost(base=pp, pools=Pools(5), wait_s=0.02,
                               now=3.0)),
        "queue_analytic": (rco.QueueAwareCost(pools=Pools(5), now=1.0),
                           pco.QueueAwareCost(pools=Pools(5), now=1.0)),
    }


@pytest.mark.parametrize("cost", ["analytic", "composite", "predictor",
                                  "queue_pools", "queue_analytic"])
def test_etc_matrix_from_cost_matches_reference(clusters, gbts, cost):
    (rt, rn), (pt, pn) = clusters
    rc, pc = cost_pairs(gbts)[cost]
    want = rsch.etc_matrix(rt, rn, cost=rc)
    got = psch.etc_matrix(pt, pn, cost=pc, device=CPU)
    assert got.dtype == np.float64 and got.shape == (len(pt), len(pn))
    assert np.array_equal(want, got)


def test_etc_matrix_default_and_scalar_predictor(clusters):
    (rt, rn), (pt, pn) = clusters
    assert np.array_equal(rsch.etc_matrix(rt, rn), psch.etc_matrix(pt, pn))
    fn = (lambda t, n: t.flops / n.spec.peak_flops)
    assert np.array_equal(rsch.etc_matrix(rt, rn, fn),
                          psch.etc_matrix(pt, pn, fn))


# --------------------------------------------------------------------------
# batch schedules
# --------------------------------------------------------------------------
def schedule_tuples(s):
    return [(a.task.name, a.node, a.start, a.finish) for a in s.assignments]


@pytest.mark.parametrize("etc_kind", ["analytic", "predictor"])
@pytest.mark.parametrize("name", ["round_robin", "random", "min_min",
                                  "max_min", "heft", "min_min_ref",
                                  "max_min_ref", "heft_ref"])
def test_schedules_match_reference(clusters, gbts, name, etc_kind):
    (rt, rn), (pt, pn) = clusters
    if etc_kind == "analytic":
        etc = psch.etc_matrix(pt, pn)
    else:
        etc = psch.etc_matrix(pt, pn, cost=cost_pairs(gbts)["predictor"][1],
                              device=CPU)
    table_r = {**rsch.SCHEDULERS,
               **{f"{k}_ref": v for k, v in rsch.SCHEDULERS_REF.items()}}
    table_p = {**psch.SCHEDULERS,
               **{f"{k}_ref": v for k, v in psch.SCHEDULERS_REF.items()}}
    want = table_r[name](rt, rn, etc.copy())
    got = table_p[name](pt, pn, etc.copy())
    assert schedule_tuples(want) == schedule_tuples(got)
    assert got.makespan == want.makespan
    assert got.mean_completion == want.mean_completion
    if name.endswith("_ref"):
        fast = table_p[name[:-4]](pt, pn, etc.copy())
        assert schedule_tuples(fast) == schedule_tuples(got)


def test_schedules_with_busy_nodes_and_deadlines():
    (rt, rn), (pt, pn) = (cluster(rsch, R_SPECS, 9, 5, True),
                          cluster(psch, P_SPECS, 9, 5, True))
    for j, (a, b) in enumerate(zip(rn, pn)):
        a.available_at = b.available_at = 0.05 * j
    etc = psch.etc_matrix(pt, pn)
    for name in ("min_min", "max_min", "heft"):
        want = rsch.SCHEDULERS[name](rt, rn, etc)
        got = psch.SCHEDULERS[name](pt, pn, etc)
        assert schedule_tuples(want) == schedule_tuples(got)
        assert want.deadline_misses() == got.deadline_misses()
    assert psch.min_min([], pn, np.zeros((0, len(pn)))).assignments == []


def test_masked_argmin_first_index_on_ties():
    fin = np.array([[3.0, 1.0, 1.0], [1.0, 2.0, 1.0]])
    active = np.array([True, True])
    assert psch.masked_argmin(fin, active) == \
        rsch.masked_argmin(fin, active) == (0, 1)
    active[0] = False
    assert psch.masked_argmin(fin, active) == (1, 0)


def test_bruteforce_and_mdp_match_reference(clusters):
    (rt, rn), (pt, pn) = clusters
    etc = psch.etc_matrix(pt[:5], pn[:3])
    assert schedule_tuples(rsch.optimal_bruteforce(rt[:5], rn[:3], etc)) \
        == schedule_tuples(psch.optimal_bruteforce(pt[:5], pn[:3], etc))
    for levels in (8, 24):
        v_r = rsch.SchedulingMDP(rt[:5], rn[:2], etc[:, :2],
                                 backlog_levels=levels).solve()
        v_p = psch.SchedulingMDP(pt[:5], pn[:2], etc[:, :2],
                                 backlog_levels=levels).solve()
        assert v_r == v_p
    mk = psch.min_min(pt[:5], pn[:2], etc[:, :2]).makespan
    assert v_p <= mk * 1.1


@pytest.mark.parametrize("policy", ["belief", "omniscient", "oblivious"])
def test_pomdp_makespans_match_reference(policy):
    rng = np.random.default_rng(0)
    flops = rng.uniform(5e10, 5e11, 30)
    rt = [rsch.Task(f"t{i}", flops=float(f)) for i, f in enumerate(flops)]
    pt = [psch.Task(f"t{i}", flops=float(f)) for i, f in enumerate(flops)]
    rn, pn = [rsch.Node(s) for s in R_SPECS], [psch.Node(s) for s in P_SPECS]
    for seed, acc in ((0, 0.9), (3, 0.4)):
        assert rpomdp.simulate(rt, rn, policy=policy, obs_accuracy=acc,
                               seed=seed) == \
            ppomdp.simulate(pt, pn, policy=policy, obs_accuracy=acc,
                            seed=seed)
    b_r = rpomdp.BeliefScheduler(rn, obs_accuracy=0.7)
    b_p = ppomdp.BeliefScheduler(pn, obs_accuracy=0.7)
    for i, o in ((0, 2), (1, 0), (0, 1)):
        b_r.observe(i, o)
        b_p.observe(i, o)
    assert np.array_equal(b_r.belief, b_p.belief)
    assert b_r.pick(rt[0]) == b_p.pick(pt[0])
