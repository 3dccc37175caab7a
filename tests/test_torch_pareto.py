"""The port's Pareto seams (``repro_torch.core.costs.pareto_front`` /
``pareto_pick`` / ``CompositeCost.pareto``) and its live split planner
(``repro_torch.sim.pareto``) against the JAX package's, on the CPU.

The fronts and picks are f64 tensor code over the same components, so they
are pinned bit for bit against the reference's numpy: masks, picks (first
index on ties, off-front entries never winning), the planner's picks,
front sizes, switch history and realised components, and the event loop's
records with a planner riding along — the smoke run and the diurnal
Pareto scenario at the reference's full size.
"""
import numpy as np
import pytest
import torch
from hypothesis_shim import given, settings, st

from repro import sim as rsim
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.core.workloads import WorkloadConfig as RWorkload
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.hw import get_device as r_get

from repro_torch import sim as psim
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.core.workloads import WorkloadConfig as PWorkload
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.hw import get_device as p_get

CPU = "cpu"
PACKS = {False: (rsim, rsch, list(R_DEVICES.values()), r_get, roff,
                 RWorkload, rco, rdec),
         True: (psim, psch, list(P_DEVICES.values()), p_get, poff,
                PWorkload, pco, pdec)}


def _dominates(a, b):
    return bool(np.all(a <= b) and np.any(a < b))


def t(x):
    return torch.as_tensor(np.asarray(x, np.float64))


def synth_layers(off, n, seed=0):
    rng = np.random.default_rng(seed)
    return [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e11)),
                          act_bytes=float(rng.uniform(1e3, 1e7)))
            for i in range(n)]


def cnn_layers(port):
    off, workload = PACKS[port][4], PACKS[port][5]
    return off.workload_layer_costs(workload("cnn", 2, epochs=5,
                                             optimiser="adam", lr=1e-3,
                                             batch_size=32))


def planner(port, cost=None, **kw):
    sim, get = PACKS[port][0], PACKS[port][3]
    if port:
        kw["torch_device"] = CPU
    return sim.ParetoStreamScheduler(cost, device=get("pi5-arm"),
                                     edge=get("edge-server-a100"), **kw)


def composite(port):
    return PACKS[port][6].CompositeCost(
        weights={"latency_s": 1.0, "energy_j": 0.02, "price": 1.0},
        price_per_edge_s=0.1, price_per_gb=0.05)


# --------------------------------------------------------------------------
# pareto_front / pareto_pick
# --------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 24), st.integers(1, 4),
       st.booleans())
def test_pareto_front_non_domination_and_reference(seed, n, k, coarse):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (n, k))
    if coarse:                           # exact ties between points
        c = np.round(c * 3) / 3
    front = pco.pareto_front(t(c)).numpy()
    assert front.shape == (n,) and front.any()
    assert np.array_equal(front, rco.pareto_front(c))
    for i in np.flatnonzero(front):
        assert not any(_dominates(c[j], c[i]) for j in range(n))
    for i in np.flatnonzero(~front):
        assert any(_dominates(c[j], c[i]) for j in range(n))


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 24), st.integers(1, 4))
def test_pareto_scalarised_argmin_on_front(seed, n, k):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.0, 1.0, (n, k))
    w = rng.uniform(0.1, 10.0, k)         # strictly positive weights
    assert pco.pareto_front(t(c))[int(np.argmin(c @ w))]


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 6), st.integers(1, 9),
       st.integers(1, 3))
def test_pareto_front_batched_matches_per_row(seed, e, s, k):
    c = np.random.default_rng(seed).uniform(0.0, 1.0, (e, s, k))
    batched = pco.pareto_front(t(c))
    assert tuple(batched.shape) == (e, s)
    for i in range(e):
        assert torch.equal(batched[i], pco.pareto_front(t(c[i])))
    assert np.array_equal(batched.numpy(), rco.pareto_front(c))


def test_pareto_front_rejects_a_vector():
    with pytest.raises(ValueError):
        pco.pareto_front(t([1.0, 2.0]))


def test_pareto_pick_is_front_restricted_scalar_argmin():
    rng = np.random.default_rng(0)
    comp = rng.uniform(0.0, 1.0, size=(5, 12, 3))
    names = ("latency_s", "energy_j", "price")
    w = {"latency_s": 1.0, "energy_j": 0.0, "price": 0.0}
    front, picks = pco.pareto_pick(t(comp), names, w)
    scalar = pco.scalarize_weighted(t(comp), names, w)
    for e in range(5):
        assert front[e, picks[e]]
        assert scalar[e, picks[e]] == scalar[e, front[e]].min()
    rf, rp = rco.pareto_pick(comp, names, w)
    assert np.array_equal(front.numpy(), rf)
    assert np.array_equal(picks.numpy(), rp)
    with pytest.raises(KeyError):
        pco.pareto_pick(t(comp), names, w, subset=("latency_s", "typo"))
    _, picks2 = pco.pareto_pick(t(comp), names, scalar=scalar)
    assert all(front[e, picks2[e]] for e in range(5))
    with pytest.raises(ValueError):
        pco.pareto_pick(t(comp), names, scalar=scalar[:, :4])


def test_pareto_pick_first_index_and_masked_inf_never_wins():
    """Ties on the front go to the first index; an off-front entry whose
    ranking is smaller (or equal) never wins over a finite on-front one."""
    names = ("latency_s", "energy_j")
    comp = t([[[1.0, 1.0], [1.0, 1.0], [2.0, 0.5], [3.0, 3.0]]])
    # split 3 is dominated; rank it lowest, and tie splits 0 and 2
    scalar = t([[5.0, 5.0, 5.0, -1.0]])
    front, picks = pco.pareto_pick(comp, names, scalar=scalar)
    assert front.tolist() == [[True, True, True, False]]
    assert picks.tolist() == [0]
    rf, rp = rco.pareto_pick(comp.numpy(), names,
                             scalar=scalar.numpy())
    assert rp.tolist() == [0] and np.array_equal(front.numpy(), rf)
    # the subset decides the domination test only
    front2, picks2 = pco.pareto_pick(comp, names, subset=("energy_j",),
                                     scalar=scalar)
    assert front2.tolist() == [[False, False, True, False]]
    assert picks2.tolist() == [2]


def test_pareto_on_decision_matrix_matches_reference():
    """The scalarised ``decide_all`` split is Pareto-optimal per
    environment, and ``CompositeCost.pareto`` is the reference's mask."""
    masks, plans = [], []
    for port in (True, False):
        co, dec, off = PACKS[port][6], PACKS[port][7], PACKS[port][4]
        get = PACKS[port][3]
        rng = np.random.default_rng(9)
        layers = [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e6, 1e12)),
                                act_bytes=float(rng.uniform(1e2, 1e8)))
                  for i in range(10)]
        kw = {"device": CPU} if port else {}
        envs = dec.make_envs(get("pi5-arm"), get("edge-server-a100"),
                             link_bw=np.geomspace(1e4, 1e10, 32),
                             input_bytes=4 * 32 * 784, **kw)
        cost = co.CompositeCost(weights={"latency_s": 1.0, "energy_j": 0.01,
                                         "price": 0.5},
                                price_per_edge_s=0.1, price_per_gb=0.01)
        masks.append(np.asarray(cost.pareto(layers, envs)))
        pk = {"backend": "torch", "device": CPU} if port else {}
        plans.append(np.asarray(dec.decide_all(layers, envs, cost=cost,
                                               **pk).splits))
    assert np.array_equal(masks[0], masks[1])
    assert np.array_equal(plans[0], plans[1])
    assert masks[0][np.arange(32), plans[0]].all()


# --------------------------------------------------------------------------
# ParetoStreamScheduler
# --------------------------------------------------------------------------
def test_pareto_stream_scheduler_lifecycle_matches_reference():
    out = []
    for port in (True, False):
        layers = cnn_layers(port)
        pl = planner(port)
        st0 = pl.admit(0, layers, 1.25e9, input_bytes=1e5)
        assert st0.front_size >= 1 and 0 <= st0.pick <= len(layers)
        with pytest.raises(KeyError):
            pl.admit(0, layers, 1.25e9)
        switched = pl.on_link(10.0)          # collapsing link
        assert pl.live[0].pick == len(layers) and switched in (0, 1)
        rec = pl.complete(0, 10.0)
        assert rec["pick"] == len(layers)
        assert rec["switches"] == pl.total_switches
        assert not pl.live and set(rec["realised"]) == set(pl.cost.objectives)
        out.append((st0.admission_pick, st0.front_size, switched, rec,
                    dict(pl.telemetry.counters)))
    assert out[0] == out[1]


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 10 ** 6), st.integers(2, 8), st.integers(1, 5))
def test_pareto_repick_stays_on_current_front(seed, n_layers, n_events):
    """Per-event re-picks are non-dominated on the *current* front
    (verified against the reference's numpy front), and every pick, front
    size and switch equals the reference planner's."""
    pls, links = [], []
    for port in (True, False):
        sim, off = PACKS[port][0], PACKS[port][4]
        pl = planner(port, composite(port))
        link = sim.RandomWalkLink(0.125e9, sigma=1.5, seed=seed + 1)
        layers = synth_layers(off, n_layers, seed=seed)
        pl.admit(0, layers, link.value, input_bytes=1e5)
        pl.admit(1, layers, link.value, input_bytes=3e6)
        pls.append((pl, layers))
        links.append(link)
    cost_r = composite(False)
    obj_idx = [cost_r.objectives.index(n) for n in pls[1][0].pareto_objectives]
    for _ in range(n_events):
        bws = [link.step(1.0) for link in links]
        assert bws[0] == bws[1]
        moved = [pl.on_link(bw) for (pl, _), bw in zip(pls, bws)]
        assert moved[0] == moved[1]
        for rid, state in pls[0][0].live.items():
            envs = rdec.make_envs(r_get("pi5-arm"),
                                  r_get("edge-server-a100"),
                                  link_bw=np.asarray([bws[1]]),
                                  link_latency_s=0.005,
                                  input_bytes=np.asarray([state.input_bytes]))
            comp = np.asarray(cost_r.components(pls[1][1], envs))[0]
            assert rco.pareto_front(comp[:, obj_idx])[state.pick]
            other = pls[1][0].live[rid]
            assert (state.pick, state.front_size, state.history) == \
                (other.pick, other.front_size, other.history)


def test_admit_batch_equals_per_task_admits_and_one_slot_cache():
    layers = cnn_layers(True)
    a, b = planner(True), planner(True)
    ibs = [1e4, 2e6, 5e5, 2e6]
    batch = a.admit_batch([3, 4, 5, 6], layers, 4e7, input_bytes=ibs,
                          now=1.0, deadlines_s=[None, 1.0, 2.0, None])
    single = [b.admit(r, layers, 4e7, input_bytes=ib, now=1.0)
              for r, ib in zip([3, 4, 5, 6], ibs)]
    assert [(s.pick, s.front_size) for s in batch] == \
        [(s.pick, s.front_size) for s in single]
    assert batch[1].deadline_s == 1.0
    assert a.telemetry.counters["split_admissions"] == 4
    envs = a._envs(4e7, ibs)
    assert a._envs(4e7, ibs) is envs            # same observation: cached
    assert a._envs(4.1e7, ibs) is not envs
    with pytest.raises(ValueError, match="equal lengths"):
        a.admit_batch([7, 8], layers, 4e7, input_bytes=[1.0])
    with pytest.raises(KeyError):
        a.admit_batch([3], layers, 4e7, input_bytes=[1.0])


def test_planner_validates_objectives_and_verifies_picks():
    with pytest.raises(KeyError, match="pareto objectives"):
        planner(True, pco.AnalyticCost())

    class Inconsistent(pco.CompositeCost):
        """Ranks every split at +inf: the front-restricted argmin then
        falls back to split 0, which is off this front."""

        def scalarize(self, components):
            return torch.full(components.shape[:-1], float("inf"),
                              dtype=torch.float64)

    layers = synth_layers(poff, 6, seed=1)
    pl = planner(True, Inconsistent(), pareto_objectives=("latency_s",))
    # a 1 GB input over 100 kB/s: split 0 is the slowest, off the front
    with pytest.raises(AssertionError, match="dominated"):
        pl.admit(0, layers, 1e5, input_bytes=1e9)
    quiet = planner(True, Inconsistent(), pareto_objectives=("latency_s",),
                    verify=False)
    assert quiet.admit(0, layers, 1e5, input_bytes=1e9).pick == 0


def test_on_saturation_counts_and_repicks():
    for port in (True, False):
        pl = planner(port)
        layers = cnn_layers(port)
        pl.admit(0, layers, 1.25e9, input_bytes=1e5)
        assert pl.on_saturation(10.0, now=2.0) == 1
        assert pl.telemetry.counters["split_saturation_repicks"] == 1
        assert pl.telemetry.counters["split_repicks"] == 1
        assert pl.on_link(10.0) == 0


# --------------------------------------------------------------------------
# the planner riding the event loop, against the reference
# --------------------------------------------------------------------------
def record_rows(tel):
    return [(r.name, r.arrived_s, r.started_s, r.finished_s, r.node,
             r.node_id, r.split, r.switches, r.energy_j)
            for r in tel.records]


def smoke_run(port, seed):
    sim, sch, specs, get, off, workload = PACKS[port][:6]
    rng = np.random.default_rng(seed)
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e7)),
                      deadline_s=float(rng.uniform(0.02, 2.0)))
             for i in range(50)]
    nodes = [sch.Node(s) for s in specs]
    arrivals = sim.mmpp_arrivals([20.0, 200.0], [0.4, 0.1], horizon=2.0,
                                 seed=seed)[:len(tasks)]
    links = sim.ClusterLinks.random_walk(
        [n.spec.link_bw for n in nodes], sigma=0.5, seed=seed + 1)
    extra = {"torch_device": CPU} if port else {}
    env = sim.DriftingEnv(device=get("pi5-arm"),
                          edge=get("edge-server-a100"),
                          link=sim.TwoStateLink(1.25e9, 2e5,
                                                mean_good_s=0.4,
                                                mean_bad_s=0.4,
                                                seed=seed + 2),
                          input_bytes=1e5, **extra)
    kw = {"device": CPU} if port else {}
    return sim.simulate_stream(tasks[:len(arrivals)], arrivals, nodes,
                               links=links, link_update_dt=0.1,
                               split_planner=planner(port), split_env=env,
                               split_layers=cnn_layers(port), **kw)


def test_sim_smoke_deterministic_seed_matches_reference():
    a, b, ref = smoke_run(True, 0), smoke_run(True, 0), smoke_run(False, 0)
    assert record_rows(a) == record_rows(b) == record_rows(ref)
    s = a.summary()
    assert s == b.summary() == ref.summary()
    assert s["n_tasks"] == len(a) > 0
    assert s["p99_completion_s"] >= s["p50_completion_s"] >= 0.0
    assert s["replans"] > 0 and s["column_refreshes"] > 0
    assert "full_rebuilds" not in s


def test_sim_end_to_end_diurnal_pareto_matches_reference():
    """The reference's full-size scenario (its slow test): 300 diurnal
    arrivals, drifting links with rebalancing, the pi5 → A100 planner on a
    two-state link.  The planner must switch splits, and every record,
    the summary and the planner's counts equal the reference's."""
    outs = []
    for port in (True, False):
        sim, sch, specs, get, off, workload = PACKS[port][:6]
        rng = np.random.default_rng(0)
        tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(5e10, 8e11)),
                          input_bytes=float(rng.uniform(1e5, 1e7)),
                          deadline_s=float(rng.uniform(5, 120)))
                 for i in range(300)]
        nodes = [sch.Node(s) for s in specs]
        arrivals = sim.diurnal_arrivals(12.0, horizon=30.0, amplitude=0.9,
                                        period_s=10.0, seed=1)[:300]
        tasks = tasks[:len(arrivals)]
        links = sim.ClusterLinks.random_walk(
            [nd.spec.link_bw for nd in nodes], sigma=0.7, seed=2)
        extra = {"torch_device": CPU} if port else {}
        env = sim.DriftingEnv(device=get("pi5-arm"),
                              edge=get("edge-server-a100"),
                              link=sim.TwoStateLink(1.25e9, 2e5,
                                                    mean_good_s=2.0,
                                                    mean_bad_s=2.0, seed=3),
                              input_bytes=1e5, **extra)
        pl = planner(port)
        kw = {"device": CPU} if port else {}
        tel = sim.simulate_stream(tasks, arrivals, nodes, policy="min_min",
                                  links=links, link_update_dt=0.5,
                                  split_planner=pl, split_env=env,
                                  split_layers=cnn_layers(port),
                                  rebalance=True, **kw)
        outs.append((tel, pl, arrivals))
    (tel, pl, arrivals), (rtel, rpl, _) = outs
    assert record_rows(tel) == record_rows(rtel)
    assert tel.summary() == rtel.summary()
    assert (pl.total_switches, pl.total_repicks) == \
        (rpl.total_switches, rpl.total_repicks)
    assert len(tel) == len(arrivals) and pl.total_switches >= 1
    for r in tel.records:
        assert r.finished_s > r.started_s >= r.arrived_s
    s = tel.summary()
    assert s["split_switches"] >= 1 and s["split_repicks"] > 0
    assert 0.0 <= s["mean_utilisation"] <= 1.0
    assert tel.makespan_s >= float(arrivals.max())
