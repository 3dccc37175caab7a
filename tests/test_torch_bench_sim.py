"""The port's decision and simulation benches (``repro_torch.bench.
{decisions,oracle,stream,fleet,contention,scheduler}``) against the
reference's ``benchmarks/`` scripts on the CPU.

Each test runs the reference's own row functions and the port's with
``device="cpu"`` on the same inputs, at the smoke sizes or smaller, and
compares every field of the reference's rows outside the port module's
``TIMED`` list (host timings are not compared):

- exact where the path is f64 and pinned: the queueing rows, the
  tail-vs-mean splits and misses, the stream makespans, the scheduler's
  rows, the drift loop's steps, refits and nRMSE track, the gain row;
- the reference's ``jax`` / ``pallas`` rows cannot run on jax 0.9 (they
  need ``enable_x64``): they are compared through its numpy / host rows
  (``decide_all``'s ``jax`` backend sent to ``numpy``, the event loop for
  the fleet engine's events, the host GBT for the lowered predictor);
- ``repro.oracle`` comes in through the bare-package fixture of
  ``tests/test_torch_oracle.py``.

No reference ``main()`` runs in full mode (it would write ``BENCH_*.json``
at the repo root); both packages' rows go under ``tmp_path``, and the
last test holds the repository's tree unchanged by these tests.
"""
import importlib
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: fields the port adds to a row beside the reference's
PORT_FIELDS = {"plain", "card", "launches", "port_backend", "scan_steps"}


def repo_state() -> tuple:
    """``git status`` of the tree and the bench outputs that the repo
    root's ``results/`` and ``BENCH_*.json`` hold, with their mtimes."""
    try:
        status = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=all"],
            cwd=ROOT, capture_output=True, text=True, timeout=60).stdout
    except OSError:
        status = None
    files = sorted((str(p), p.stat().st_mtime_ns) for pat in (
        "BENCH_*.json", "results/bench_*.json",
        "results/profiling_records*.json") for p in ROOT.glob(pat))
    return status, files


@pytest.fixture(scope="module", autouse=True)
def untouched_repo():
    """The repository as it was before this module's tests."""
    state = repo_state()
    yield state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: torch's CPU thread pool beside JAX's only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def results(tmp_path, monkeypatch):
    """Both packages' rows under ``tmp_path``; the reference's scripts
    importable as ``benchmarks.*``."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import common as bcommon

    from repro_torch.bench import common as pcommon
    monkeypatch.setattr(bcommon, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(pcommon, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def ref_bench(name):
    return importlib.import_module(f"benchmarks.{name}")


def port_bench(name):
    return importlib.import_module(f"repro_torch.bench.{name}")


def assert_rows_match(got, want, timed, exact=True, rtol=0.0):
    """Every reference row has the port's row of its name, with every
    field outside ``timed`` equal (``exact``) or within ``rtol``."""
    by_name = {r["name"]: r for r in got}
    assert len(by_name) == len(got), "duplicate row names"
    for w in want:
        g = by_name[w["name"]]
        assert g.get("plain") is True, g
        extra = set(g) - set(w) - PORT_FIELDS - set(timed)
        assert not extra, (w["name"], extra)
        for k, v in w.items():
            if k in timed:
                continue
            if exact or not isinstance(v, float):
                assert g[k] == v, (w["name"], k, g[k], v)
            else:
                np.testing.assert_allclose(g[k], v, rtol=rtol,
                                           err_msg=f"{w['name']}.{k}")


# -- decisions -------------------------------------------------------------
def test_decisions_rows_match_the_reference(results):
    ref, port = ref_bench("bench_decisions"), port_bench("decisions")
    want = ref.main(smoke=True)
    got = port.main(smoke=True, device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    assert (results / "bench_torch_decisions.json").exists()


def test_decision_cost_rows_match_the_reference(results):
    ref, port = ref_bench("bench_decisions"), port_bench("decisions")
    want = ref.main_costs("all", smoke=True)
    got = port.main_costs("all", smoke=True, device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    assert next(r for r in got if "predictor" in r["name"])[
        "predict_calls"] == 1


def test_decision_backend_rows_match_the_reference_numpy_rows(results):
    ref, port = ref_bench("bench_decisions"), port_bench("decisions")
    want = ref.main_backends("numpy", smoke=True)
    got = port.main_backends("all", smoke=True, device="cpu")
    # on the CPU only the CPU's rows run, under the reference's numpy names
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert {r["port_backend"] for r in got} == {"torch"}
    assert_rows_match(got, want, port.TIMED)


def test_decision_sweeps_equal_the_reference_plans():
    """The rows' sweeps themselves: the port's env sweep and its exact
    backend sweep pick the reference's splits at the same costs."""
    from repro.core import decisions as rdec
    from repro.core import offload as roff
    from repro.hw import get_device as rget

    from repro_torch.core import decisions as pdec
    port = port_bench("decisions")
    layers = port.synth_layers(64)
    rlayers = [roff.LayerCost(lc.name, flops=lc.flops,
                              act_bytes=lc.act_bytes) for lc in layers]
    bws = np.geomspace(1e5, 1e10, 256)
    env = port.make_env()
    renv = roff.OffloadEnv(device=rget("pi5-arm"),
                           edge=rget("edge-server-a100"), link_bw=0.125e9,
                           input_bytes=1e5)
    want = rdec.sweep_links(rlayers, renv, bws)
    got = pdec.sweep_links(layers, env, bws, backend="torch", device=CPU)
    assert np.array_equal(got.splits.numpy(), np.asarray(want.splits))
    assert np.array_equal(got.total_time_s.numpy(),
                          np.asarray(want.total_time_s))


# -- oracle ----------------------------------------------------------------
@pytest.fixture
def ref_oracle(monkeypatch, results):
    """The reference's bench under a bare ``repro.oracle`` package that
    carries ``OnlineOracle`` (``lowered`` needs ``enable_x64``), with
    ``decide_all``'s ``jax`` backend sent to ``numpy``."""
    stub = types.ModuleType("repro.oracle")
    stub.__path__ = [str(ROOT / "src" / "repro" / "oracle")]
    monkeypatch.setitem(sys.modules, "repro.oracle", stub)
    for sub in ("online", "registry"):
        monkeypatch.setitem(sys.modules, f"repro.oracle.{sub}", None)
        del sys.modules[f"repro.oracle.{sub}"]
    stub.OnlineOracle = importlib.import_module(
        "repro.oracle.online").OnlineOracle
    stub.lower_predictor = None          # the jax rows do not run here
    from repro.core import decisions as rdec
    decide_all = rdec.decide_all

    def numpy_for_jax(*a, backend="numpy", **kw):
        return decide_all(*a, backend="numpy" if backend == "jax"
                          else backend, **kw)

    monkeypatch.setattr(rdec, "decide_all", numpy_for_jax)
    monkeypatch.delitem(sys.modules, "benchmarks.bench_oracle",
                        raising=False)
    return ref_bench("bench_oracle")


def test_oracle_drift_and_gain_rows_equal_the_reference(ref_oracle,
                                                       monkeypatch):
    """At the smoke size, on both sides the scenario's GBT with 80 trees
    instead of 150, to keep the test short."""
    port = port_bench("oracle")
    fit = ref_oracle.fit_profiling_gbt
    monkeypatch.setattr(ref_oracle, "fit_profiling_gbt", lambda **kw: fit(
        n_trees=80, max_depth=8, n_layers=512))
    want = ref_oracle.bench_drift(smoke=True)
    got = port.drift_rows(True, "cpu", CPU, model=port.fit_profiling_gbt(
        n_trees=80, max_depth=8, n_layers=512, device=CPU))
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    assert got[0]["refits"] >= 1 and abs(got[1]["gain"] - 2.0) < 0.25


def test_oracle_decide_rows_match_the_reference_numpy_row(ref_oracle):
    port = port_bench("oracle")
    want = ref_oracle.bench_decide(smoke=True)
    got = port.decide_rows(4096, 3, [("cpu", CPU)])
    assert [r["name"] for r in want] == ["decide_predictor_numpy_envs4096",
                                         "decide_predictor_jax_envs4096"]
    assert_rows_match(got, want[:1], port.TIMED)


def test_oracle_predict_rows_and_model_match_the_reference(ref_oracle):
    """The sweep's GBT is the reference's node for node and predicts the
    reference's values on the sweep's rows; the CPU rows are the
    reference's host rows (its jitted rows run through them)."""
    from repro.kernels.tree_predict.ref import flatten_gbt as rflat

    from repro_torch.kernels.tree_predict.ref import flatten_gbt as pflat
    port = port_bench("oracle")
    rm = ref_oracle.fit_profiling_gbt()
    pm = port.fit_profiling_gbt(device=CPU)
    a, b = rflat(rm), pflat(pm)
    for f in ("feature", "threshold_bin", "left", "right", "value",
              "n_nodes", "edges"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    for x in port.predict_features((1024, 4096)):
        assert np.array_equal(pm.predict(x, device=CPU).numpy(),
                              np.asarray(rm.predict(x)))
    got = port.predict_rows((1024, 4096), 1, [("cpu", CPU)])
    want = [{"name": f"tree_predict_host_{n}", "backend": "host",
             "n_rows": n} for n in (1024, 4096)]
    assert_rows_match(got, want, port.TIMED)


def test_oracle_path_shape_rows_time_the_plain_version():
    port = port_bench("oracle")
    from repro_torch.core.predictors import GBTRegressor
    x, y = port.layer_training_set(port.synth_layers(32))
    gbt = GBTRegressor(n_trees=6, max_depth=3).fit(x, y, device=CPU)
    rows = port.path_shape_rows(gbt, "cpu", CPU)
    assert [r["name"] for r in rows] == ["tree_predict_oracle_r1",
                                         "tree_predict_oracle_r32"]
    for r, n in zip(rows, (1, 32)):
        assert r["shape"][:2] == [n, 6] and r["plain_us"] > 0
        assert r["plain"] is True and r["timing"] == "host"


# -- stream, fleet, contention, scheduler ----------------------------------
def test_stream_rows_match_the_reference(results):
    ref, port = ref_bench("bench_stream"), port_bench("stream")
    want = ref.main(smoke=True)
    got = port.main(smoke=True, device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    tasks, arr, nodes = port.cell(200.0, 32, 300)
    rtasks = ref.make_tasks(300, seed=232)
    assert [(t.flops, t.input_bytes) for t in tasks] == [
        (t.flops, t.input_bytes) for t in rtasks]
    assert len(nodes) == 32 and len(arr) == 300


def test_fleet_gate_spread_reads_the_smoke_cell_gate():
    """``bench.fleet.gate_spread``: independent readings of the tracing
    gate at the smoke cell, each a positive finite ratio, sorted, with the
    readings over the 1.10 bar counted."""
    port = port_bench("fleet")
    got = port.gate_spread(2, "cpu")
    assert got["path"] == "cpu" and got["readings"] == 2
    assert len(got["ratios"]) == 2 and got["ratios"] == sorted(got["ratios"])
    assert all(np.isfinite(r) and r > 0 for r in got["ratios"])
    assert got["over_bar"] == sum(r > 1.10 for r in got["ratios"])


def test_fleet_rows_match_the_reference_event_loop(results):
    """The event loop's rows against the reference's, and the fleet
    engine's (its plain version on the CPU) events equal to them: the
    reference's own fleet engine needs ``enable_x64``."""
    ref, port = ref_bench("bench_fleet"), port_bench("fleet")
    from repro_torch.bench.common import GateBroken
    cells, horizon = [(500, 8), (1500, 16)], 120.0
    try:
        got = port.fleet_rows(cells, horizon, 1, [("cpu", CPU)], full=False)
    except GateBroken as e:
        # the rows, whatever this host's clock made of the time gates
        # (held on the card by chip_smoke phase 15)
        assert all(g.startswith(("fleet engine (cpu) slower",
                                 "tracing overhead")) for g in e.gates)
        got = e.rows
    names = [r["name"] for r in got]
    assert names == ["fleet_host_t500_n8", "fleet_fleet_t500_n8",
                     "fleet_host_t1500_n16", "fleet_fleet_t1500_n16",
                     "fleet_traced_t1500_n16"]
    for n_tasks, n_nodes in cells:
        _, events = ref.run_engine("event", n_tasks, n_nodes, horizon)
        want = {"name": f"fleet_host_t{n_tasks}_n{n_nodes}",
                "engine": "host", "n_tasks": n_tasks, "n_nodes": n_nodes,
                "horizon_s": horizon, "events": events,
                "events_per_sec": 0.0, "total_ms": 0.0}
        assert_rows_match(got, [want], port.TIMED)
        fleet = next(r for r in got
                     if r["name"] == f"fleet_fleet_t{n_tasks}_n{n_nodes}")
        assert fleet["events"] == events and fleet["plain"] is True
    traced = got[-1]
    assert traced["n_spans"] >= 2 * 1500 and traced["engine"] == "fleet+obs"
    tasks, arr, nodes, links = port.fleet_day(500, 8, horizon)
    assert len(tasks) == len(arr) == 500 and len(links().processes) == 8


def test_contention_rows_equal_the_reference(results):
    ref, port = ref_bench("bench_contention"), port_bench("contention")
    want = (ref.bench_throughput_vs_rho(2000)
            + ref.bench_p99_vs_capacity(2000)
            + ref.bench_incremental_wait(2000))
    got = (port.bench_throughput_vs_rho(2000)
           + port.bench_p99_vs_capacity(2000)
           + port.bench_incremental_wait(2000))
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)


def test_contention_tail_vs_mean_equals_the_reference(results):
    """The splits behind each policy's misses: the port's exact sweep on
    the CPU is numpy's, bit for bit, so the misses, latencies and offload
    shares are the reference's."""
    ref, port = ref_bench("bench_contention"), port_bench("contention")
    want = ref.bench_tail_vs_mean(30.0)
    got = port.bench_tail_vs_mean(30.0, path="cpu", dev=CPU)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    assert want[0]["deadline_misses"] > 0


def test_contention_main_on_the_cpu_runs_every_section(results):
    port = port_bench("contention")
    rows = port.main(smoke=True, device="cpu")
    assert {r["name"].split("_")[1] for r in rows} == {
        "rho0.3", "rho0.7", "rho0.9", "p99", "incremental", "mmpp"}
    assert all(r["plain"] for r in rows)


def test_rows_gate_through_obs_regress(results, capsys):
    """The rows a bench writes are a baseline that ``python -m
    repro_torch.obs.analyze regress`` reads and passes its self-test on."""
    from repro_torch.obs.analyze.cli import main as analyze
    port_bench("contention").main(smoke=True, device="cpu")
    path = results / "bench_torch_contention.json"
    assert analyze(["regress", str(path), "--selftest"]) == 0
    assert "selftest PASS" in capsys.readouterr().out


def test_scheduler_rows_equal_the_reference(results):
    ref, port = ref_bench("bench_scheduler"), port_bench("scheduler")
    want = ref.main()
    got = port.main(device="cpu")
    assert [r["name"] for r in got] == [r["name"] for r in want]
    assert_rows_match(got, want, port.TIMED)
    assert (results / "bench_torch_scheduler.json").exists()


# -- devices and the tree ---------------------------------------------------
SIM_BENCHES = ("decisions", "oracle", "stream", "fleet", "contention",
               "scheduler")


@pytest.mark.parametrize("name", SIM_BENCHES)
def test_bench_without_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_bench(name).main()


@pytest.mark.parametrize("mode", ("main_costs", "main_backends"))
def test_decision_modes_without_device_need_a_card(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        getattr(port_bench("decisions"), mode)("all", smoke=True)


def test_kernel_row_without_its_kernel_fails():
    """A card row that names a kernel never launched fails, so no row
    times a fallback in silence."""
    from repro_torch.bench import common
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "card", lambda: "H100, 700.00 W")
        row = common.tag({"name": "x"}, "kernel", {"decide_split": 2},
                         ("decide_split",))
        assert row["launches"] == {"decide_split": 2}
        assert row["card"] == "H100, 700.00 W"
        with pytest.raises(AssertionError, match="not launched"):
            common.tag({"name": "y"}, "kernel", {}, ("decide_split",))
        with pytest.raises(AssertionError, match="none named"):
            common.tag({"name": "z"}, "kernel", {"tree_predict": 1})
    assert common.tag({"name": "c"}, "cpu") == {"name": "c", "plain": True}


def test_the_benches_wrote_nothing_into_the_repo(untouched_repo):
    """Runs last in this module: the tree and the repo root's bench
    outputs are as they were before the tests above."""
    assert repo_state() == untouched_repo
