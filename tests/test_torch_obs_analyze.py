"""The port's ``repro_torch.obs.analyze`` against the JAX package's
``repro.obs.analyze``, on the CPU, case by case after
``tests/test_obs_analyze.py``.

Each case of the reference's file runs on the port, and where the
reference computes a number the port's is held to it on the same input:
attribution of a traced port run reproduces its ``Telemetry.summary()``
exactly and equals the reference's attribution of the reference's run
(summary, phase totals, per-task rows, miss classification); ``diff``
reports are the reference's; ``QuantileSketch`` quantiles are the
reference's bit for bit; ``compare_rows`` / ``selftest`` and the CLI give
the reference's verdicts, exit codes and output on the same row files; the
miss classifier matches the reference's golden file.
"""
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from hypothesis_shim import given, settings, st

from repro import obs as robs
from repro import sim as rsim
from repro.core import scheduler as rsch
from repro.hw import EDGE_DEVICES as R_DEVICES
from repro.obs import analyze as ranalyze
from repro.obs.analyze.cli import main as r_main

from repro_torch import sim as psim
from repro_torch.core import scheduler as psch
from repro_torch.hw import EDGE_DEVICES as P_DEVICES
from repro_torch.obs import MetricsRegistry, Tracer, postmortem_dump
from repro_torch.obs.analyze import (MISS_CAUSES, QuantileSketch,
                                     TraceTable, attribute, compare_rows,
                                     diff, ks_statistic, load, selftest)
from repro_torch.obs.analyze.cli import main as analyze_main

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"
SIDES = {
    "ref": types.SimpleNamespace(sim=rsim, sch=rsch,
                                 specs=list(R_DEVICES.values()), kw={}),
    "port": types.SimpleNamespace(sim=psim, sch=psch,
                                  specs=list(P_DEVICES.values()),
                                  kw={"device": CPU}),
}


def make_tasks(sch, n, seed=3, deadline_slack=None):
    rng = np.random.default_rng(seed)
    return [sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 5e11)),
                     input_bytes=float(rng.uniform(1e4, 1e7)),
                     deadline_s=float(rng.uniform(*deadline_slack))
                     if deadline_slack else None)
            for i in range(n)]


def run_traced(engine, *, side="port", n_tasks=40, n_nodes=3, seed=5,
               contended=True, deadlines=True):
    """``tests/test_obs_analyze.py``'s traced run on either package ->
    (Telemetry, Tracer)."""
    m = SIDES[side]
    tasks = make_tasks(m.sch, n_tasks, seed=seed,
                       deadline_slack=(0.05, 2.0) if deadlines else None)
    arrivals = m.sim.poisson_arrivals(15.0, n=n_tasks, seed=seed)
    kw = dict(m.kw)
    if contended:
        kw["pools"] = m.sim.NodePools.uniform(n_nodes, 1)
        kw["rtt"] = m.sim.WeibullRTT(shape=0.7, scale=0.01, seed=seed + 9)
    obs = robs.Tracer() if side == "ref" else Tracer()
    nodes = [m.sch.Node(m.specs[j % len(m.specs)]) for j in range(n_nodes)]
    tel = m.sim.simulate_stream(tasks, arrivals, nodes, policy="min_min",
                                engine=engine, obs=obs, **kw)
    return tel, obs


def same_attribution(got, want):
    """Two RunAttributions hold the same numbers, bit for bit."""
    assert got.summary() == want.summary()
    assert got.phase_totals() == want.phase_totals()
    assert got.by_track() == want.by_track()
    assert got.per_task() == want.per_task()
    assert got.miss_attribution() == want.miss_attribution()
    assert got.table_str() == want.table_str()


# --------------------------------------------------------------------------
# attribution: exact summary reproduction from spans alone
# --------------------------------------------------------------------------
EXACT_KEYS = ("n_tasks", "p50_completion_s", "p90_completion_s",
              "p99_completion_s", "mean_completion_s", "p99_wait_s",
              "mean_wait_s", "deadline_misses", "miss_rate")


@pytest.mark.parametrize("engine", ["event", "fleet"])
def test_attribution_reproduces_summary_exactly(engine):
    tel, obs = run_traced(engine)
    s_span = attribute(obs).summary()
    s_tel = tel.summary()
    for k in EXACT_KEYS:
        assert s_span[k] == s_tel[k], (k, s_span[k], s_tel[k])
    _, ref = run_traced("event", side="ref")
    same_attribution(attribute(obs), ranalyze.attribute(ref))


@pytest.mark.parametrize("engine", ["event", "fleet"])
def test_attribution_phase_totals_and_critical_path(engine):
    tel, obs = run_traced(engine)
    run = attribute(obs)
    totals = run.phase_totals()
    assert totals["sojourn"] == pytest.approx(
        totals["queue_wait"] + totals["service"] + totals["transfer"]
        + totals["residual"])
    shares = run.phase_shares()
    assert sum(shares.values()) == pytest.approx(1.0)
    assert sum(d["n_tasks"] for d in run.by_track().values()) \
        == len(run.tasks)
    ref = ranalyze.attribute(run_traced(engine, side="ref")[1])
    assert shares == ref.phase_shares()
    for i in range(len(run.tasks)):
        segs = run.critical_path(i)
        assert segs, "no critical path for a completed task"
        assert sum(d for _, d, _ in segs) == pytest.approx(
            float(run.tasks.sojourn_s[i]))
        assert run.dominant_phase(i) == max(
            segs, key=lambda s: s[1])[0]
        assert segs == ref.critical_path(i)


@settings(max_examples=12, deadline=None)
@given(engine=st.sampled_from(["event", "fleet"]),
       seed=st.integers(0, 50), n_tasks=st.integers(5, 30),
       contended=st.booleans())
def test_phases_sum_to_sojourn_property(engine, seed, n_tasks,
                                        contended):
    _, obs = run_traced(engine, n_tasks=n_tasks, seed=seed,
                        contended=contended)
    t = attribute(obs).tasks
    assert len(t) == n_tasks
    recon = t.queue_wait_s + t.service_s + t.transfer_s + t.residual_s
    assert np.abs(t.sojourn_s - recon).max() <= 1e-9
    assert np.abs(t.residual_s).max() <= 1e-9
    assert np.abs(t.phase_matrix().sum(axis=1)
                  - t.sojourn_s).max() <= 1e-9


def test_telemetry_bridge_matches_tracer_phases():
    tel, obs = run_traced("event")
    via_rows = tel.attribution()
    via_spans = attribute(obs)
    assert len(via_rows.tasks) == len(via_spans.tasks)
    np.testing.assert_array_equal(via_rows.tasks.sojourn_s,
                                  via_spans.tasks.sojourn_s)
    np.testing.assert_array_equal(via_rows.tasks.queue_wait_s,
                                  via_spans.tasks.queue_wait_s)
    np.testing.assert_array_equal(via_rows.tasks.transfer_s,
                                  via_spans.tasks.transfer_s)
    ref, _ = run_traced("event", side="ref")
    same_attribution(via_rows, ref.attribution())


def test_telemetry_bridge_takes_the_reference_fault():
    """A record whose service rounds below zero: the port's rows bridge
    ends service at ``started``, as its tracer does, so the two attribute
    alike; the reference's bridge builds a negative service span."""
    wait, transfer = 15.844593384656818, 49.128718932516044
    rec = dict(name="t0", arrived_s=0.0, started_s=wait,
               finished_s=wait + 0.0 + transfer, node="n", node_id=0,
               transfer_s=transfer)
    tel = psim.Telemetry()
    tel.complete(psim.TaskRecord(**rec))
    ref = rsim.Telemetry()
    ref.complete(rsim.TaskRecord(**rec))
    tracer = Tracer()
    tracer.task_spans("n@0", 0, "t0", 0.0, wait, wait + transfer,
                      transfer_s=transfer)
    via_rows = tel.attribution().tasks
    assert via_rows.service_s[0] == 0.0
    assert ref.attribution().tasks.service_s[0] < 0.0
    np.testing.assert_array_equal(via_rows.phase_matrix(),
                                  attribute(tracer).tasks.phase_matrix())


def test_summary_new_keys():
    tel, _ = run_traced("event")
    s = tel.summary()
    soj = sorted(r.sojourn_s for r in tel.records)
    assert s["p90_completion_s"] == float(np.percentile(soj, 90))
    assert s["miss_rate"] == s["deadline_misses"] / s["n_tasks"]
    assert psim.Telemetry().summary()["miss_rate"] == 0.0


# --------------------------------------------------------------------------
# differential profiling
# --------------------------------------------------------------------------
def test_diff_run_with_itself_is_identically_zero():
    _, obs = run_traced("event")
    for align in ("task", "arrival"):
        rep = diff(obs, obs, align=align)
        assert rep.is_zero
        assert rep.only_a == rep.only_b == 0
        for p in rep.phases.values():
            assert (p.mean_delta, p.p50_delta, p.p90_delta,
                    p.p99_delta, p.ks) == (0.0,) * 5
        assert all(r["sojourn_delta_s"] == 0.0
                   for r in rep.top_regressions)


def test_diff_event_vs_fleet_identical_seeds_all_zero():
    _, obs_e = run_traced("event")
    _, obs_f = run_traced("fleet")
    rep = diff(obs_e, obs_f)
    assert rep.is_zero, rep.table_str()


def test_diff_detects_regression():
    _, a = run_traced("event", seed=5)
    _, b = run_traced("event", seed=6)
    rep = diff(a, b)
    assert not rep.is_zero
    assert rep.matched == len(load(a).lifecycles())
    d = rep.to_dict()
    assert set(d["phases"]) == {"sojourn", "queue_wait", "service",
                                "transfer"}
    assert "diff" in rep.table_str()
    _, ra = run_traced("event", side="ref", seed=5)
    _, rb = run_traced("event", side="ref", seed=6)
    for align in ("task", "arrival"):
        want = ranalyze.diff(ra, rb, align=align, top_k=5)
        got = diff(a, b, align=align, top_k=5)
        assert got.to_dict() == want.to_dict()
        assert got.table_str() == want.table_str()


def test_ks_statistic_properties():
    rng = np.random.default_rng(0)
    x = rng.normal(size=500)
    assert ks_statistic(x, x) == 0.0
    assert ks_statistic(x, x + 100.0) == 1.0
    assert 0.0 < ks_statistic(x, x + 0.5) < 1.0
    assert ks_statistic(np.empty(0), np.empty(0)) == 0.0
    assert ks_statistic(np.empty(0), x) == 1.0
    y = rng.normal(0.3, 1.2, size=333)
    assert ks_statistic(x, y) == ranalyze.ks_statistic(x, y)


# --------------------------------------------------------------------------
# streaming quantile sketch
# --------------------------------------------------------------------------
def sketch_stream(dist, rng, n):
    return {"lognormal": lambda: rng.lognormal(0.0, 1.0, n),
            "uniform": lambda: rng.uniform(0.0, 10.0, n),
            "exponential": lambda: rng.exponential(2.0, n),
            "bimodal": lambda: np.concatenate(
                [rng.normal(1.0, 0.1, n // 2),
                 rng.normal(10.0, 1.0, n // 2)])}[dist]()


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exponential",
                                  "bimodal"])
def test_sketch_p99_within_2pct(dist):
    x = sketch_stream(dist, np.random.default_rng(42), 20_000)
    s, r = QuantileSketch("lat"), ranalyze.QuantileSketch("lat")
    for chunk in np.array_split(x, 37):
        s.observe_many(chunk)
        r.observe_many(chunk)
    assert s.n_centroids <= 128
    assert len(s) == x.size and s.sum == pytest.approx(x.sum())
    for q in (0.5, 0.9, 0.99):
        exact = float(np.percentile(x, 100 * q))
        assert abs(s.quantile(q) - exact) <= 0.02 * abs(exact), (q, dist)
    assert s.quantile(0.0) == x.min() and s.quantile(1.0) == x.max()
    # the reference's sketch on the same chunks: the same bits
    for q in np.linspace(0.0, 1.0, 41):
        assert s.quantile(q) == r.quantile(q)
    assert s.to_row("p_") == r.to_row("p_")
    assert s.expose() == r.expose()


def test_sketch_exact_when_small():
    x = np.asarray([3.0, 1.0, 4.0, 1.5, 9.0])
    s = QuantileSketch(max_centroids=16)
    s.observe_many(x)
    assert s.quantile(0.0) == 1.0 and s.quantile(1.0) == 9.0
    assert s.quantile(0.5) == pytest.approx(np.percentile(x, 50), rel=0.3)
    assert s.mean == pytest.approx(x.mean())
    r = ranalyze.QuantileSketch(max_centroids=16)
    r.observe_many(x)
    assert s.quantiles_dict() == r.quantiles_dict()
    # a tensor observed in one piece: the same sketch
    t = QuantileSketch(max_centroids=16)
    t.observe_many(torch.as_tensor(x))
    assert t.quantiles_dict() == s.quantiles_dict()


def test_sketch_merge_approximates_union():
    rng = np.random.default_rng(1)
    a, b = rng.lognormal(0, 1, 8000), rng.lognormal(0.5, 0.8, 8000)
    sa, sb = QuantileSketch("a"), QuantileSketch("b")
    sa.observe_many(a)
    sb.observe_many(b)
    sa.merge(sb)
    both = np.concatenate([a, b])
    assert len(sa) == both.size
    assert sa.sum == pytest.approx(both.sum())
    for q in (0.5, 0.99):
        exact = float(np.percentile(both, 100 * q))
        assert abs(sa.quantile(q) - exact) <= 0.02 * abs(exact)
    ra, rb = ranalyze.QuantileSketch("a"), ranalyze.QuantileSketch("b")
    ra.observe_many(a)
    rb.observe_many(b)
    ra.merge(rb)
    assert [sa.quantile(q) for q in (0.01, 0.5, 0.9, 0.99)] == \
        [ra.quantile(q) for q in (0.01, 0.5, 0.9, 0.99)]


def test_sketch_validations():
    s = QuantileSketch()
    with pytest.raises(ValueError, match="non-finite"):
        s.observe(float("nan"))
    with pytest.raises(ValueError, match="q must be"):
        s.quantile(1.5)
    with pytest.raises(ValueError, match="max_centroids"):
        QuantileSketch(max_centroids=2)
    assert s.quantile(0.5) == 0.0


def test_registry_summary_kind():
    reg, ref = MetricsRegistry(), robs.MetricsRegistry()
    q = reg.quantile("sojourn_seconds", help="live sojourn")
    assert q is reg.quantile("sojourn_seconds")
    q.observe_many(np.arange(1.0, 101.0))
    ref.quantile("sojourn_seconds", help="live sojourn").observe_many(
        np.arange(1.0, 101.0))
    text = reg.to_prometheus()
    assert "# TYPE sojourn_seconds summary" in text
    assert 'sojourn_seconds{quantile="0.99"}' in text
    assert "sojourn_seconds_count 100" in text
    assert text == ref.to_prometheus()
    rows = reg.to_rows()
    (srow,) = [r for r in rows if "quantiles" in r]
    assert srow["count"] == 100 and "0.99" in srow["quantiles"]
    assert rows == ref.to_rows()
    with pytest.raises(TypeError, match="already registered"):
        reg.counter("sojourn_seconds")
    with pytest.raises(ValueError, match="max_centroids"):
        reg.quantile("sojourn_seconds", max_centroids=64)


def test_serving_engines_expose_live_quantiles():
    reg = MetricsRegistry()
    soj = reg.quantile("serve_sojourn_seconds")
    rng = np.random.default_rng(3)
    soj.observe_many(rng.exponential(0.1, 500))
    text = reg.to_prometheus()
    assert 'serve_sojourn_seconds{quantile="0.5"}' in text
    import inspect
    from repro_torch.serve.continuous import ContinuousBatchEngine
    from repro_torch.serve.engine import ServeEngine
    assert "metrics" in inspect.signature(
        ContinuousBatchEngine.__init__).parameters
    assert "metrics" in inspect.signature(ServeEngine.__init__).parameters


# --------------------------------------------------------------------------
# miss attribution: taxonomy + golden pin on a saturating MMPP run
# --------------------------------------------------------------------------
def _mmpp_saturating_run(side="port"):
    m = SIDES[side]
    n_nodes = 3
    arrivals = m.sim.mmpp_arrivals([40.0, 400.0], [0.5, 0.2],
                                   horizon=2.0, seed=11)
    rng = np.random.default_rng(11)
    tasks = [m.sch.Task(f"t{i}", flops=float(rng.uniform(1e9, 2e11)),
                        input_bytes=float(rng.uniform(1e4, 1e6)),
                        deadline_s=float(arrivals[i]
                                         + rng.uniform(0.005, 0.3)))
             for i in range(len(arrivals))]
    obs = robs.Tracer() if side == "ref" else Tracer()
    tel = m.sim.simulate_stream(
        tasks, arrivals, [m.sch.Node(m.specs[j % len(m.specs)])
                          for j in range(n_nodes)], policy="min_min",
        pools=m.sim.NodePools.uniform(n_nodes, 1),
        rtt=m.sim.WeibullRTT(shape=0.6, scale=0.02, seed=13),
        engine="event", obs=obs, **m.kw)
    return tel, obs


def test_miss_attribution_taxonomy():
    tel, obs = run_traced("event", n_tasks=60, seed=9)
    ma = attribute(obs).miss_attribution()
    assert ma["n_misses"] == tel.summary()["deadline_misses"]
    assert sum(ma["by_cause"].values()) == ma["n_misses"]
    assert set(ma["by_cause"]) == set(MISS_CAUSES)
    for m in ma["misses"]:
        assert m["cause"] in MISS_CAUSES
        assert m["excess_s"] > 0.0
        assert m["dominant_phase"] in ("queue_wait", "transfer",
                                       "service")
        assert {"queue_wait": "pool_contention",
                "transfer": m["cause"],
                "service": "service_underprediction"}[
                    m["dominant_phase"]] == m["cause"]
    _, ref = run_traced("event", side="ref", n_tasks=60, seed=9)
    assert ma == ranalyze.attribute(ref).miss_attribution()
    assert MISS_CAUSES == ranalyze.MISS_CAUSES


def test_miss_attribution_golden_mmpp():
    _, obs = _mmpp_saturating_run()
    ma = attribute(obs).miss_attribution()
    got = {
        "n_tasks": ma["n_tasks"], "n_misses": ma["n_misses"],
        "by_cause": ma["by_cause"],
        "misses": [{"task": m["task"], "cause": m["cause"],
                    "dominant_phase": m["dominant_phase"]}
                   for m in ma["misses"]],
    }
    want = json.loads((GOLDEN / "miss_attribution_mmpp.json").read_text())
    assert got == want
    assert ma["n_misses"] >= 5
    assert ma["by_cause"]["pool_contention"] >= 1
    _, ref = _mmpp_saturating_run("ref")
    assert ma == ranalyze.attribute(ref).miss_attribution()


def test_instant_corroboration_windows():
    runs = []
    for m in (None, robs):
        tr = Tracer() if m is None else m.Tracer()
        tr.task_spans("n@0", 0, "a", 0.0, 0.9, 1.0,
                      args={"deadline_s": 0.5})
        tr.task_spans("n@0", 1, "b", 0.0, 0.0, 0.6)
        tr.instant("scheduler", "pool_saturation", 0.4)
        runs.append(attribute(tr) if m is None
                    else ranalyze.attribute(tr))
    run, ref = runs
    (miss,) = run.miss_attribution()["misses"]
    assert miss["cause"] == "pool_contention"
    assert miss["corroborated"] and miss["evidence"] == [
        "pool_saturation"]
    table = run.table.instants_in(0.0, 1.0, names=("pool_saturation",))
    assert len(table) == 1
    assert run.table.instants_in(0.5, 1.0) == []
    assert run.miss_attribution() == ref.miss_attribution()


# --------------------------------------------------------------------------
# trace table ingestion paths
# --------------------------------------------------------------------------
def test_from_chrome_round_trip(tmp_path):
    _, obs = run_traced("event", n_tasks=20)
    path = tmp_path / "trace.json"
    obs.export_chrome(str(path))
    t_exact = TraceTable.from_tracer(obs).lifecycles()
    t_chrome = load(str(path)).lifecycles()
    assert len(t_chrome) == len(t_exact)
    np.testing.assert_allclose(t_chrome.sojourn_s, t_exact.sojourn_s,
                               atol=1e-9)
    np.testing.assert_allclose(t_chrome.queue_wait_s,
                               t_exact.queue_wait_s, atol=1e-9)
    assert t_chrome.task == t_exact.task
    assert np.isfinite(t_chrome.deadline_s).all()
    # the reference reads the port's file into the same columns
    t_ref = ranalyze.load(str(path)).lifecycles()
    np.testing.assert_array_equal(t_ref.phase_matrix(),
                                  t_chrome.phase_matrix())


def test_span_arrays_args_cols():
    tr = Tracer()
    tr.span_arrays(["n@0", "n@1"], [0, 1], ["x", "y"], [0.0, 1.0],
                   [0.1, 1.0], [0.5, 2.0],
                   args_cols={"deadline_s": [0.4, None],
                              "split": [3, None]})
    t = load(tr).lifecycles()
    assert t.deadline_s[0] == 0.4 and np.isnan(t.deadline_s[1])
    assert t.split[0] == 3 and t.split[1] == -1
    assert bool(t.missed[0]) and not bool(t.missed[1])
    with pytest.raises(ValueError, match="args column"):
        tr.span_arrays(["n@0"], [0], ["x"], [0.0], [0.0], [1.0],
                       args_cols={"deadline_s": [1.0, 2.0]})


# --------------------------------------------------------------------------
# regression gating
# --------------------------------------------------------------------------
def both_reports(base, fresh, **kw):
    got = compare_rows(base, fresh, **kw)
    assert got.to_dict() == ranalyze.compare_rows(base, fresh,
                                                  **kw).to_dict()
    return got


def test_compare_rows_directions():
    base = [{"name": "b", "us_per_call": 100.0, "events_per_sec": 1e4,
             "rel_err": 0.01, "backend": "jax", "n_envs": 64}]
    assert both_reports(base, base).ok
    worse = [{**base[0], "us_per_call": 130.0}]
    rep = both_reports(base, worse)
    assert not rep.ok and rep.regressions[0].metric == "us_per_call"
    better = [{**base[0], "us_per_call": 50.0, "events_per_sec": 9e4}]
    rep = both_reports(base, better)
    assert rep.ok and len(rep.improvements) == 2
    rep = both_reports(base, [{**base[0], "events_per_sec": 100.0}])
    assert not rep.ok
    rep = both_reports(base, [{**base[0], "backend": "numpy"}])
    assert not rep.ok
    rep = both_reports(base, [{"name": "other", "us_per_call": 1.0}])
    assert not rep.ok and rep.missing_rows == ["b"]
    assert rep.extra_rows == ["other"]
    assert both_reports(base, worse, tol={"us_per_call": 0.5}).ok
    assert both_reports(base, worse, tol={"b.us_per_call": 0.5}).ok
    assert rep.table_str() == ranalyze.compare_rows(
        base, [{"name": "other", "us_per_call": 1.0}]).table_str()


def test_selftest_on_committed_baselines():
    from repro_torch.obs.analyze.regress import direction_of, load_rows
    rows = load_rows(str(REPO / "BENCH_7.json"))
    ok, text = selftest(rows)
    assert ok, text
    assert "selftest PASS" in text
    assert (ok, text) == ranalyze.selftest(rows)
    from repro.obs.analyze.regress import direction_of as r_direction
    assert all(direction_of(k) == r_direction(k)
               for r in rows for k in r)


def run_main(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("bench", ["BENCH_3.json", "BENCH_6.json"])
def test_regress_cli_exit_codes(bench, tmp_path):
    base = str(REPO / bench)
    rows = json.loads(pathlib.Path(base).read_text())
    for r in rows:
        for k, v in list(r.items()):
            if isinstance(v, float) and v != 0:
                r[k] = v * 2.0 if not any(
                    s in k for s in ("per_sec", "per_s", "speedup")) \
                    else v / 2.0
    bad = tmp_path / "fresh.json"
    bad.write_text(json.dumps(rows))
    for argv, rc in ((["regress", base, base], 0),
                     (["regress", base, "--selftest"], 0),
                     (["regress", base, str(bad)], 1),
                     (["regress", base, str(tmp_path / "nope.json")], 2)):
        got = run_main(analyze_main, argv)
        assert got[0] == rc
        # the reference's exit code and output on the same files
        assert got == run_main(r_main, argv)


def test_regress_cli_json_report(tmp_path):
    base = str(REPO / "BENCH_7.json")
    out = tmp_path / "report.json"
    assert run_main(analyze_main, ["regress", base, base, "--json",
                                   str(out)])[0] == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["checked"] > 0
    ref = tmp_path / "ref.json"
    run_main(r_main, ["regress", base, base, "--json", str(ref)])
    assert out.read_bytes() == ref.read_bytes()


# --------------------------------------------------------------------------
# CLI: attribution + diff on exported traces
# --------------------------------------------------------------------------
def test_cli_attribution_and_diff(tmp_path):
    _, obs_a = run_traced("event", n_tasks=20)
    _, obs_b = run_traced("fleet", n_tasks=20)
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    obs_a.export_chrome(str(pa))
    obs_b.export_chrome(str(pb))
    out = tmp_path / "attr.json"
    argv = ["attribution", str(pa), "--misses", "--json", str(out)]
    got = run_main(analyze_main, argv)
    assert got[0] == 0
    report = json.loads(out.read_text())
    assert report["summary"]["n_tasks"] == 20
    assert set(report["miss_attribution"]["by_cause"]) \
        == set(MISS_CAUSES)
    ref_out = tmp_path / "ref_attr.json"
    want = run_main(r_main, argv[:-1] + [str(ref_out)])
    assert got[1].replace(str(out), "") == want[1].replace(str(ref_out), "")
    assert out.read_bytes() == ref_out.read_bytes()
    dout = tmp_path / "diff.json"
    argv = ["diff", str(pa), str(pb), "--json", str(dout)]
    got = run_main(analyze_main, argv)
    assert got[0] == 0
    d = json.loads(dout.read_text())
    assert d["matched"] == 20
    assert abs(d["phases"]["sojourn"]["mean_delta"]) < 1e-6
    assert got[1] == run_main(r_main, argv)[1]
    assert run_main(analyze_main, ["attribution",
                                   str(tmp_path / "missing.json")])[0] == 2


def test_cli_runs_as_a_module(tmp_path):
    """``python -m repro_torch.obs.analyze``: the gate's exit codes from
    the shell (0 clean, 1 on a regression, 2 on a missing file)."""
    base = str(REPO / "BENCH_7.json")
    rows = json.loads(pathlib.Path(base).read_text())
    rows[0] = {k: (v * 3.0 if isinstance(v, float) and v else v)
               for k, v in rows[0].items()}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(rows))
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    codes = [subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.analyze", "regress", base,
         fresh], capture_output=True, text=True, env=env).returncode
        for fresh in (base, str(bad), str(tmp_path / "nope.json"))]
    assert codes == [0, 1, 2]


# --------------------------------------------------------------------------
# flight-recorder post-mortem
# --------------------------------------------------------------------------
def test_postmortem_on_engine_crash(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)

    class BoomRTT:
        def sample(self, n):
            raise RuntimeError("boom")

    tasks = make_tasks(psch, 1, deadline_slack=(0.5, 1.0))
    nodes = [psch.Node(SIDES["port"].specs[0])]
    obs = Tracer()
    with pytest.raises(RuntimeError, match="boom"):
        psim.simulate_stream(tasks, np.asarray([0.0]), nodes,
                             rtt=BoomRTT(), obs=obs, device=CPU)
    dump = json.loads(
        (tmp_path / "results" / "postmortem.json").read_text())
    assert dump["error"].startswith("RuntimeError")
    assert dump["n_events"] >= 1
    assert "post-mortem" in capsys.readouterr().err
    (tmp_path / "results" / "postmortem.json").unlink()
    with pytest.raises(RuntimeError, match="boom"):
        psim.simulate_stream(tasks, np.asarray([0.0]), nodes,
                             rtt=BoomRTT(), device=CPU)
    assert not (tmp_path / "results" / "postmortem.json").exists()


def test_postmortem_dump_propagates_its_own_failure(tmp_path):
    """The port's deliberate deviation: where the reference swallows a
    failed dump and returns None, the port raises (a failing disk is not
    hidden); a dump that can be written is the reference's."""
    tr = Tracer()
    tr.instant("x", "e", 1.0)
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        postmortem_dump(tr, clock_s=1.0,
                        path=str(blocker / "postmortem.json"))
    out = tmp_path / "pm.json"
    d = postmortem_dump(tr, clock_s=2.5, error="E", path=str(out))
    assert d["clock_s"] == 2.5 and out.exists()
    ref = robs.Tracer()
    ref.instant("x", "e", 1.0)
    want = robs.postmortem_dump(ref, clock_s=2.5, error="E",
                                path=str(tmp_path / "ref.json"))
    assert d == want
