"""The port's online oracle and registry against the JAX package's.

``repro.oracle`` cannot be imported with jax 0.9 (its ``__init__``
imports ``lowered``, which needs ``jax.experimental.enable_x64``), but ``online.py`` and ``registry.py`` are numpy code: the
``ref`` fixture puts a bare package for ``repro.oracle`` into
``sys.modules`` (undone after each test) and imports the two from the
reference's sources.  The reference's ``OracleCost.accel_spec`` needs
``lowered``, so the port's sweeps are held against the reference's
``backend="numpy"`` path.

Pinned bit for bit, on the CPU: the Page–Hinkley state and triggers, the
gain/bias EWMA, drift steps, refit versions, the rolling nRMSE track and
the refit trees (``flatten_gbt`` arrays, single and multi-target),
``OracleCost`` against ``PredictorCost`` in a static world, the
registry's versions, rollback and ``keep``, a registry directory written
by either package loaded by the other, and ``simulate_stream`` with the
oracle, static and drifted, against the reference's.
"""
import importlib
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from repro import sim as rsim
from repro.core import costs as rco
from repro.core import decisions as rdec
from repro.core import offload as roff
from repro.core import scheduler as rsch
from repro.core.predictors import GBTRegressor as RGBT
from repro.core.predictors import MultiTargetGBT as RMulti
from repro.core.predictors import RidgeRegressor as RRidge
from repro.hw import EDGE_DEVICES as R_DEVICES

from repro_torch import sim as psim
from repro_torch.core import costs as pco
from repro_torch.core import decisions as pdec
from repro_torch.core import offload as poff
from repro_torch.core import scheduler as psch
from repro_torch.core.predictors import GBTRegressor as PGBT
from repro_torch.core.predictors import MultiTargetGBT as PMulti
from repro_torch.core.predictors import RidgeRegressor as PRidge
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.kernels.tree_predict.ref import flatten_gbt
from repro_torch.oracle import (OnlineOracle, OracleCost, PageHinkley,
                                PredictorRegistry)

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
R_SPECS, P_SPECS = list(R_DEVICES.values()), list(P_DEVICES.values())
TREE_FIELDS = ("feature", "threshold_bin", "left", "right", "value",
               "n_nodes", "edges")
GBT_KW = dict(n_trees=25, max_depth=4)


@pytest.fixture
def ref(monkeypatch):
    """The reference's ``online`` and ``registry`` modules, imported under
    a bare ``repro.oracle`` package that lives only for this test."""
    stub = types.ModuleType("repro.oracle")
    stub.__path__ = [str(ROOT / "src" / "repro" / "oracle")]
    monkeypatch.setitem(sys.modules, "repro.oracle", stub)
    for sub in ("online", "registry"):
        monkeypatch.setitem(sys.modules, f"repro.oracle.{sub}", None)
        del sys.modules[f"repro.oracle.{sub}"]
    return types.SimpleNamespace(
        online=importlib.import_module("repro.oracle.online"),
        registry=importlib.import_module("repro.oracle.registry"))


def rand_layers(off, rng, n):
    return [off.LayerCost(f"l{i}", flops=float(rng.uniform(1e8, 1e11)),
                          act_bytes=float(rng.uniform(1e3, 1e7)))
            for i in range(n)]


def training_set(off, co, specs, layers):
    x = np.concatenate([co.default_layer_features(layers, s)
                        for s in specs])
    y = np.concatenate([[off.layer_time(lc.flops, s) for lc in layers]
                        for s in specs])
    return x, y


def both_sets(seed, n):
    """The same per-layer training rows built by each package."""
    return (training_set(roff, rco, R_SPECS,
                         rand_layers(roff, np.random.default_rng(seed), n)),
            training_set(poff, pco, P_SPECS,
                         rand_layers(poff, np.random.default_rng(seed), n)))


def assert_same_trees(a, b):
    fa, fb = flatten_gbt(a), flatten_gbt(b)
    for f in TREE_FIELDS:
        assert np.array_equal(getattr(fa, f), getattr(fb, f)), f
    assert fa.base == fb.base


@pytest.fixture(scope="module")
def gbts():
    """The reference's and the port's GBT on the same rows: identical
    trees, so identical predictions."""
    (rx, ry), (px, py) = both_sets(0, 24)
    r = RGBT(**GBT_KW, subsample=0.9, seed=1).fit(rx, ry)
    p = PGBT(**GBT_KW, subsample=0.9, seed=1).fit(px, py, device=CPU)
    assert_same_trees(r, p)
    return r, p


def oracles(ref, gbts, **kw):
    r, p = gbts
    return (ref.online.OnlineOracle(r, R_SPECS[2], R_SPECS[-1], **kw),
            OnlineOracle(p, P_SPECS[2], P_SPECS[-1], torch_device=CPU,
                         **kw))


# --------------------------------------------------------------------------
# Page–Hinkley
# --------------------------------------------------------------------------
PH_STATE = ("n", "mean", "_m2", "_m_lo", "_m_hi", "_lo_min", "_hi_max")


@pytest.mark.parametrize("shift,scale", [(0.8, 0.1), (-0.8, 0.1),
                                         (0.3, 1.0), (5.0, 0.1)])
def test_page_hinkley_state_and_triggers_bit_for_bit(ref, shift, scale):
    rng = np.random.default_rng(12)
    stream = np.concatenate([rng.normal(0.0, scale, 300),
                             rng.normal(shift, scale, 300)])
    r, p = ref.online.PageHinkley(), PageHinkley()
    fired = []
    for i, x in enumerate(stream):
        a, b = r.update(x), p.update(x)
        assert a == b
        if a:
            fired.append(i)
            r.reset()
            p.reset()
        assert [getattr(r, k) for k in PH_STATE] == \
            [getattr(p, k) for k in PH_STATE]
        assert r.std == p.std
    assert fired and fired[0] >= 300        # the shift fires, not before


def test_page_hinkley_reset_and_min_samples():
    rng = np.random.default_rng(14)
    ph = PageHinkley()
    for _ in range(100):
        ph.update(rng.normal(0.0, 0.1))
    ph.reset()
    assert ph.n == 0 and ph.std == 0.0
    for _ in range(ph.min_samples - 1):
        assert not ph.update(rng.normal(5.0, 0.1))


# --------------------------------------------------------------------------
# the residual correction
# --------------------------------------------------------------------------
@pytest.mark.parametrize("correction,factor", [("gain", 2.0), ("bias", 1.5),
                                               ("none", 3.0)])
def test_correction_ewma_bit_for_bit(ref, gbts, correction, factor):
    """Realised times a fixed factor of the uncorrected prediction: the
    port's gain/bias track the reference's, step for step, exactly."""
    ro, po = oracles(ref, gbts, refit_on_drift=False,
                     correction=correction)
    (rx, _), (px, _) = both_sets(18, 8)
    for i in range(120):
        a, b = ro.predict_one(rx[i % len(rx)]), po.predict_one(px[i % len(px)])
        assert a == b
        ra = factor * (a / ro.gain if ro.gain else a) - ro.bias
        rb = factor * (b / po.gain if po.gain else b) - po.bias
        out_r = ro.observe(rx[i % len(rx)], realised_s=ra)
        out_p = po.observe(px[i % len(px)], realised_s=rb)
        assert out_r == out_p
        assert (ro.gain, ro.bias) == (po.gain, po.bias)
    assert ro.rolling_nrmse() == po.rolling_nrmse()
    if correction == "gain":
        assert abs(po.gain - 2.0) < 0.15
    elif correction == "none":
        assert (po.gain, po.bias) == (1.0, 0.0)


def test_correct_identity_returns_its_input(gbts):
    o = OnlineOracle(gbts[1], P_SPECS[2], P_SPECS[-1], torch_device=CPU)
    t, a = torch.arange(3.0, dtype=torch.float64), np.arange(3.0)
    assert o.correct(t) is t and o.correct(a) is a
    o.gain, o.bias = 2.0, -1.0
    assert torch.equal(o.correct(t), torch.tensor([0.0, 1.0, 3.0],
                                                  dtype=torch.float64))
    assert np.array_equal(o.correct(a), [0.0, 1.0, 3.0])


# --------------------------------------------------------------------------
# drift -> refit, bit for bit with the reference
# --------------------------------------------------------------------------
def drift_loop(oracle, off, specs, seed, steps=700, at=200):
    """``examples/oracle_serving.py``'s step 3: the 12 W and 15 W specs
    3x slower from step ``at``.  Returns (drift steps, refit versions,
    rolling nRMSE track)."""
    rng = np.random.default_rng(seed)
    drifts, refits, track = [], [], []
    for step in range(steps):
        spec = specs[int(rng.integers(len(specs)))]
        flops = float(rng.uniform(1e8, 1e11))
        f = oracle.feature_fn([off.LayerCost("q", flops=flops,
                                             act_bytes=0.0)], spec)[0]
        t = off.layer_time(flops, spec)
        if step >= at and spec.tdp_watts in (12, 15):
            t *= 3.0
        out = oracle.observe(f, t)
        if out["drift"]:
            drifts.append(step)
        if out["refit_version"] is not None:
            refits.append((step, out["refit_version"]))
        track.append(oracle.rolling_nrmse())
    return drifts, refits, track


def test_drift_refit_and_recovery_bit_for_bit(ref):
    (rx, ry), (px, py) = both_sets(19, 48)
    r = RGBT(**GBT_KW).fit(rx, ry)
    p = PGBT(**GBT_KW).fit(px, py, device=CPU)
    kw = dict(window=256, min_refit=120, correction="none")
    ro = ref.online.OnlineOracle(r, R_SPECS[2], R_SPECS[-1], **kw)
    po = OnlineOracle(p, P_SPECS[2], P_SPECS[-1], torch_device=CPU, **kw)
    rd, rr, rt = drift_loop(ro, roff, R_SPECS, 20)
    pd, pr, pt = drift_loop(po, poff, P_SPECS, 20)
    assert (rd, rr) == (pd, pr)
    assert rt == pt                          # the nRMSE track, exactly
    assert po.drift_triggers >= 1 and po.refits >= 1 and po.version >= 1
    assert (ro.version, ro.refits) == (po.version, po.refits)
    assert_same_trees(ro.model, po.model)    # the refit, node for node
    peak = max(pt[200:])
    assert float(np.mean(pt[-50:])) < 0.5 * peak
    meta_r = ro.registry.current().meta
    meta_p = po.registry.current().meta
    assert meta_r == meta_p


def test_multi_target_refit_only_served_column_bit_for_bit(ref):
    """A MultiTargetGBT refits only its served ensemble; the port's refit
    equals the reference's, the other target keeps its trees."""
    rng = np.random.default_rng(30)
    x = rng.normal(size=(240, 5)).astype(np.float32)
    y = np.stack([x[:, 0], 2.0 * x[:, 1]], axis=1)
    r = RMulti(n_trees=8, max_depth=3).fit(x, y)
    p = PMulti(n_trees=8, max_depth=3).fit(x, y, device=CPU)
    ro = ref.online.OnlineOracle(r, R_SPECS[2], R_SPECS[-1],
                                 target_index=1)
    po = OnlineOracle(p, P_SPECS[2], P_SPECS[-1], target_index=1,
                      torch_device=CPU)
    before = p.predict(x, device=CPU)
    for i in range(64):
        assert ro.observe(x[i], float(y[i, 1]) * 3.0) == \
            po.observe(x[i], float(y[i, 1]) * 3.0)
    assert ro.refit() == po.refit() == 1
    for a, b in zip(ro.model.models_, po.model.models_):
        assert_same_trees(a, b)
    assert po.model.models_[0] is p.models_[0]
    after = po.model.predict(x, device=CPU)
    assert torch.equal(after[:, 0], before[:, 0])
    assert not torch.equal(after[:, 1], before[:, 1])
    assert ro.predict_one(x[0]) == po.predict_one(x[0])


def test_refit_guards(gbts):
    o = OnlineOracle(gbts[1], P_SPECS[2], P_SPECS[-1], torch_device=CPU)
    with pytest.raises(ValueError, match="refit"):
        o.refit()
    with pytest.raises(ValueError, match="correction"):
        OnlineOracle(gbts[1], P_SPECS[2], P_SPECS[-1], correction="x",
                     torch_device=CPU)
    (_, _), (px, py) = both_sets(31, 4)
    ridge = PRidge().fit(px, py, device=CPU)
    o = OnlineOracle(ridge, P_SPECS[2], P_SPECS[-1], target_index=1,
                     torch_device=CPU)
    for f in px[:8]:
        o.observe(f, 1.0, predicted_s=1.0)
    with pytest.raises(TypeError, match="target_index"):
        o.refit()


# --------------------------------------------------------------------------
# OracleCost
# --------------------------------------------------------------------------
def sweep_inputs(seed, n_layers=24, n_envs=96):
    rl = rand_layers(roff, np.random.default_rng(seed), n_layers)
    pl = rand_layers(poff, np.random.default_rng(seed), n_layers)
    bw = np.geomspace(1e5, 1e10, n_envs)
    re = rdec.make_envs(R_SPECS[2], R_SPECS[-1], link_bw=bw,
                        input_bytes=1e5)
    pe = pdec.make_envs(P_SPECS[2], P_SPECS[-1], link_bw=bw,
                        input_bytes=1e5, device=CPU)
    return rl, re, pl, pe


def assert_plans_equal(r, p):
    assert np.array_equal(r.splits, p.splits.numpy())
    assert np.array_equal(r.total_time_s, p.total_time_s.numpy())
    assert np.array_equal(r.device_time_s, p.device_time_s.numpy())
    assert np.array_equal(r.edge_time_s, p.edge_time_s.numpy())


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_oracle_cost_is_predictor_cost_bitwise(ref, gbts, backend):
    rl, re, pl, pe = sweep_inputs(16)
    ro, po = oracles(ref, gbts)
    cost = po.cost_model()
    assert isinstance(cost, OracleCost)
    a = pdec.decide_all(pl, pe, cost=pco.PredictorCost(gbts[1], P_SPECS[2],
                                                       P_SPECS[-1]),
                        backend=backend, device=CPU)
    b = pdec.decide_all(pl, pe, cost=cost, backend=backend, device=CPU)
    assert_plans_equal(types.SimpleNamespace(
        **{k: getattr(a, k).numpy() for k in
           ("splits", "total_time_s", "device_time_s", "edge_time_s")}), b)
    if backend == "torch":
        assert_plans_equal(rdec.decide_all(rl, re, cost=ro.cost_model()), b)


def slow_down(oracle, feats, factor=2.0, n=120):
    """``tests/test_oracle.py``'s uniform-slowdown loop: moves the gain."""
    for i in range(n):
        f = feats[i % len(feats)]
        pred = oracle.predict_one(f)
        oracle.observe(f, realised_s=factor * pred / oracle.gain)


def test_corrected_sweep_matches_reference_and_kernel_is_near_optimal(
        ref, gbts):
    """After the gain has moved, the port's f64 sweep over the oracle's
    cost equals the reference's numpy sweep bit for bit, and the kernel
    route (its plain f32 twin on CPU tensors, the correction lowered into
    ``LoweredLayerTimes``) is near-optimal against it."""
    ro, po = oracles(ref, gbts, refit_on_drift=False)
    (rx, _), (px, _) = both_sets(18, 8)
    slow_down(ro, rx)
    slow_down(po, px)
    assert ro.gain == po.gain != 1.0
    rl, re, pl, pe = sweep_inputs(17)
    cost = po.cost_model()
    exact = pdec.decide_all(pl, pe, cost=cost, backend="torch", device=CPU)
    assert_plans_equal(rdec.decide_all(rl, re, cost=ro.cost_model()), exact)
    spec = cost.accel_spec()
    assert spec.lowered.correction == (po.gain, po.bias)
    fast = pdec.decide_all(pl, pe, cost=cost, backend="kernel", device=CPU)
    assert bool((fast.total_time_s <= exact.total_time_s * (1 + 1e-4)
                 + 1e-12).all())


def test_oracle_cost_follows_the_correction_on_the_same_inputs(ref,
                                                                gbts):
    """One OracleCost swept twice over the same layers and envs, the gain
    moved in between: the second sweep is the corrected one, equal to a
    fresh reference cost model's (the reference's own instance would
    return its memo of the first sweep)."""
    ro, po = oracles(ref, gbts, refit_on_drift=False)
    rl, re, pl, pe = sweep_inputs(23)
    cost = po.cost_model()
    first = pdec.decide_all(pl, pe, cost=cost, backend="torch", device=CPU)
    (rx, _), (px, _) = both_sets(18, 8)
    slow_down(ro, rx)
    slow_down(po, px)
    second = pdec.decide_all(pl, pe, cost=cost, backend="torch", device=CPU)
    assert not torch.equal(first.total_time_s, second.total_time_s)
    assert_plans_equal(rdec.decide_all(rl, re, cost=ro.cost_model()),
                       second)


def test_oracle_cost_picks_up_refit(ref, gbts):
    """After a refit the same OracleCost serves the new version (the
    port's three-slot memos flushed), equal to the reference's."""
    (rx, ry), (px, py) = both_sets(20, 16)
    ro, po = oracles(ref, gbts)
    rc, pc = ro.cost_model(), po.cost_model()
    rl, re, pl, pe = sweep_inputs(21, n_layers=6, n_envs=8)
    t0 = pc.layer_times(pl, CPU)
    pdec.decide_all(pl, pe, cost=pc, backend="torch", device=CPU)
    for i in range(40):
        ro.observe(rx[i % len(rx)], float(ry[i % len(ry)]) * 4.0)
        po.observe(px[i % len(px)], float(py[i % len(py)]) * 4.0)
    assert ro.refit() == po.refit() == 1
    t1 = pc.layer_times(pl, CPU)
    assert pc.model is po.model
    assert not torch.equal(t0[0], t1[0])
    r1 = rc.layer_times(rl)
    assert np.array_equal(r1[0], t1[0].numpy())
    assert np.array_equal(r1[1], t1[1].numpy())
    assert_plans_equal(rdec.decide_all(rl, re, cost=rc),
                       pdec.decide_all(pl, pe, cost=pc, backend="torch",
                                       device=CPU))


def test_oracle_task_matrix_matches_reference(ref, gbts):
    ro, po = oracles(ref, gbts, refit_on_drift=False)
    rng = np.random.default_rng(22)
    spec = [(float(rng.uniform(1e9, 5e11)), float(rng.uniform(1e4, 1e7)))
            for _ in range(9)]
    rt = [rsch.Task(f"t{i}", flops=f, input_bytes=b)
          for i, (f, b) in enumerate(spec)]
    pt = [psch.Task(f"t{i}", flops=f, input_bytes=b)
          for i, (f, b) in enumerate(spec)]
    rn, pn = [rsch.Node(s) for s in R_SPECS], [psch.Node(s) for s in P_SPECS]
    for _ in range(2):                  # identity, then a moved gain
        assert np.array_equal(
            rsch.etc_matrix(rt, rn, cost=ro.cost_model()),
            psch.etc_matrix(pt, pn, cost=po.cost_model(), device=CPU))
        (rx, _), (px, _) = both_sets(18, 8)
        slow_down(ro, rx, n=30)
        slow_down(po, px, n=30)


# --------------------------------------------------------------------------
# the oracle riding simulate_stream
# --------------------------------------------------------------------------
def stream_case(sch, specs, seed, n_tasks, horizon, input_bytes=True):
    rng = np.random.default_rng(seed)
    nodes = [sch.Node(specs[j % len(specs)]) for j in range(4)]
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e8, 5e11)),
                      input_bytes=float(rng.uniform(1e4, 1e6))
                      if input_bytes else 0.0)
             for i in range(n_tasks)]
    arrivals = np.sort(rng.uniform(0.0, horizon, n_tasks))
    return tasks, arrivals, nodes


def record_tuples(tel):
    return [(r.name, r.node, r.node_id, r.arrived_s, r.started_s,
             r.finished_s, r.energy_j, r.split) for r in tel.records]


def test_oracle_stream_static_is_transparent_and_matches_reference(
        ref, gbts):
    """Static world, no drift: the oracle places exactly like the plain
    PredictorCost, the correction stays identity, and the records and
    summary equal the reference's."""
    r, p = gbts
    rt, ra, rn = stream_case(rsch, R_SPECS, 15, 40, 10.0)
    pt, pa, pn = stream_case(psch, P_SPECS, 15, 40, 10.0)
    plain = psim.simulate_stream(
        pt, pa, pn, cost=pco.PredictorCost(p, P_SPECS[2], P_SPECS[-1]),
        device=CPU)
    ro, po = oracles(ref, gbts)
    want = rsim.simulate_stream(rt, ra, rn, oracle=ro)
    got = psim.simulate_stream(pt, pa, pn, oracle=po, device=CPU)
    assert record_tuples(plain) == record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()
    assert po.refits == 0 and po.drift_triggers == 0
    assert (po.gain, po.bias) == (1.0, 0.0)
    assert got.summary()["oracle_observations"] == len(pt)
    with pytest.raises(ValueError, match="oracle"):
        psim.simulate_stream(pt, pa, pn, cost=pco.AnalyticCost(), oracle=po,
                             device=CPU)


def drifted_case(off, co, sch, specs):
    """``tests/test_oracle.py``'s drifted-stream fixture, drawn by one
    generator as there: 48 layers' training rows, then 400 tasks."""
    rng = np.random.default_rng(32)
    x, y = training_set(off, co, specs, rand_layers(off, rng, 48))
    tasks = [sch.Task(f"t{i}", flops=float(rng.uniform(1e8, 1e11)),
                      input_bytes=0.0) for i in range(400)]
    arrivals = np.sort(rng.uniform(0.0, 400.0, len(tasks)))
    return x, y, tasks, arrivals, [sch.Node(s) for s in specs]


def truth(off):
    """Ground truth: the 12 W and 15 W nodes 3x slower from t = 130 s."""
    def fn(task, spec, etc_s, start_s):
        slow = 3.0 if start_s >= 130.0 and spec.tdp_watts in (12, 15) \
            else 1.0
        return slow * off.layer_time(task.flops, spec)
    return fn


def test_oracle_stream_drifted_matches_reference(ref):
    """``examples/oracle_serving.py``'s step 4, second half, with
    ``tests/test_oracle.py``'s GBT (30 trees, depth 5): the ground truth
    slows two node classes mid-run; the oracle detects and refits through
    the loop, and every record, counter and gauge equals the
    reference's."""
    rx, ry, rt, ra, rn = drifted_case(roff, rco, rsch, R_SPECS)
    px, py, pt, pa, pn = drifted_case(poff, pco, psch, P_SPECS)
    r = RGBT(n_trees=30, max_depth=5).fit(rx, ry)
    p = PGBT(n_trees=30, max_depth=5).fit(px, py, device=CPU)
    kw = dict(window=256, min_refit=64, correction="none")
    ro = ref.online.OnlineOracle(r, R_SPECS[2], R_SPECS[-1], **kw)
    po = OnlineOracle(p, P_SPECS[2], P_SPECS[-1], torch_device=CPU, **kw)
    want = rsim.simulate_stream(rt, ra, rn, oracle=ro,
                                service_time_fn=truth(roff))
    got = psim.simulate_stream(pt, pa, pn, oracle=po,
                               service_time_fn=truth(poff), device=CPU)
    assert record_tuples(got) == record_tuples(want)
    assert got.summary() == want.summary()
    assert po.drift_triggers >= 1 and po.refits >= 1
    assert (po.drift_triggers, po.refits) == (ro.drift_triggers, ro.refits)
    assert_same_trees(ro.model, po.model)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ridges():
    (rx, ry), (px, py) = both_sets(0, 24)
    return RRidge().fit(rx, ry), PRidge().fit(px, py, device=CPU)


def test_registry_versions_rollback_and_keep(ref, gbts, ridges):
    """The same publish / rollback / get sequence on both registries."""
    regs = (ref.registry.PredictorRegistry(keep=2),
            PredictorRegistry(keep=2))
    models = ((ridges[0], gbts[0]), (ridges[1], gbts[1]))
    for reg, (ridge, gbt) in zip(regs, models):
        assert reg.version == -1
        with pytest.raises(LookupError):
            reg.current()
        assert (reg.publish(ridge, tag="a"), reg.publish(gbt, tag="b"),
                reg.version) == (0, 1, 1)
        assert reg.current().model is gbt and reg.get(0).model is ridge
        reg.rollback(0)
        assert reg.version == 0 and reg.current().model is ridge
        assert reg.publish(gbt) == 2         # never re-minted
        assert reg.get(1).model is gbt
        for _ in range(2):
            reg.publish(ridge)
        with pytest.raises(LookupError):
            reg.get(1)                       # past keep=2
        assert reg.get(4).model is ridge
    assert sorted(regs[0]._history) == sorted(regs[1]._history)
    with pytest.raises(ValueError):
        PredictorRegistry(keep=0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_registry_directory_loads_in_the_other_package(ref, gbts, ridges,
                                                       tmp_path, writer):
    """A registry directory written by either package loads in the other:
    the current pointer, the version counter, and predictions of the
    current (GBT, bit for bit) and older (ridge) versions."""
    root = str(tmp_path / "reg")
    if writer == "reference":
        w = ref.registry.PredictorRegistry(root=root)
        w.publish(ridges[0], tag="first")
        w.publish(gbts[0], tag="second")
        loaded = PredictorRegistry.load(root)
    else:
        w = PredictorRegistry(root=root)
        w.publish(ridges[1], tag="first")
        w.publish(gbts[1], tag="second")
        loaded = ref.registry.PredictorRegistry.load(root)
    assert loaded.version == 1 and loaded.current().tag == "second"
    assert loaded.publish(ridges[0 if writer == "port" else 1]) == 2
    (rx, _), (px, _) = both_sets(21, 7)
    want = gbts[0].predict(rx)
    cur, old = loaded.get(1).model, loaded.get(0).model
    if writer == "reference":
        assert np.array_equal(cur.predict(px, device=CPU).numpy(), want)
        np.testing.assert_allclose(old.predict(px, device=CPU).numpy(),
                                   ridges[0].predict(rx), rtol=1e-12)
    else:
        assert np.array_equal(cur.predict(rx), want)
        np.testing.assert_allclose(old.predict(rx), ridges[0].predict(rx),
                                   rtol=1e-12)


def test_registry_rollback_persists_the_pointer(tmp_path, ridges, gbts):
    root = str(tmp_path / "reg")
    reg = PredictorRegistry(root=root)
    reg.publish(ridges[1])
    reg.publish(gbts[1])
    reg.rollback(0)
    loaded = PredictorRegistry.load(root)
    assert loaded.version == 0
    assert loaded.publish(gbts[1]) == 2      # past every bundle on disk
