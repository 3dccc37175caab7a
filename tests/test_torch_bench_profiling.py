"""The port's profiling-dataset benches (``repro_torch.bench.{fig2a_mlp,
fig2b_gbt,fig3_predictions,offload,fl,serving}``) and
``bench.common.profiling_dataset`` against the reference's scripts on the
CPU.

Both packages read one small records file (the port's ``generate`` at 6
runs, one step each) written under ``tmp_path`` as each package's cache
(``profiling_records.json`` and ``profiling_records_torch.json``), with
``REPRO_PROFILE_RUNS`` at 6 and the reference's ``N_RUNS`` and paths set on
its module (``benchmarks.common`` reads them at import).  Every field of
the reference's rows outside the port module's ``TIMED`` list is compared:

- exactly where the path is f64 and pinned: the offload splits, latencies
  and the predictor-driven regret, the GBT nRMSE of Fig. 2b and Fig. 3;
- within ``MLP_RTOL`` where the port trains an MLP in f32 PyTorch (Fig.
  2a, Fig. 3's MLP, FedAvg): both start from the reference MLP's initial
  weights (the port's own come from a ``torch.Generator``), as
  ``tests/test_torch_examples_models.py`` does;
- the serving rows hold timings only: their names, and each request's 16
  new tokens.

To keep the tests short, Fig. 2a runs its smallest and largest presets
for 3 epochs, Fig. 2b the grid's corners (depth 2 and 12, subsample 0.5
and 0.8), the centralised MLPs of Fig. 3 and the FL bench 20 epochs,
FedAvg 2 rounds, and the reference's serving bench one family.
"""
import importlib
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from repro.core.predictors.mlp import MLPRegressor as RMLP

from repro_torch.core.dataset import generate, save_records
from repro_torch.core.predictors.mlp import MLPRegressor

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
N_RUNS = 6
PORT_FIELDS = {"plain", "card", "launches", "port_backend", "tokens_out"}
# f32 Adam on the same batches from the same initial weights: the
# nRMSEs within 1e-3 relative of the reference's (the trajectories part
# by rounding only)
MLP_RTOL = 1e-3


def repo_state() -> tuple:
    """``git status`` of the tree and the bench outputs and caches that
    the repo root's ``results/`` and ``BENCH_*.json`` hold, with their
    mtimes."""
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
    yield repo_state()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: torch's CPU thread pool beside JAX's only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records_dir(tmp_path_factory):
    """One measured profiling dataset as both packages' cache."""
    d = tmp_path_factory.mktemp("profiling")
    records, _ = generate(n_runs=N_RUNS, max_steps=1, device=CPU)
    for name in ("profiling_records.json", "profiling_records_torch.json"):
        save_records(records, str(d / name))
    return d


@pytest.fixture
def results(records_dir, monkeypatch):
    """Both packages' rows and caches in ``records_dir``; the reference's
    scripts importable as ``benchmarks.*``."""
    monkeypatch.setenv("REPRO_PROFILE_RUNS", str(N_RUNS))
    monkeypatch.setenv("REPRO_RESULTS", str(records_dir))
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import common as bcommon

    from repro_torch.bench import common as pcommon
    monkeypatch.setattr(bcommon, "RESULTS_DIR", str(records_dir))
    monkeypatch.setattr(bcommon, "RECORDS_PATH",
                        str(records_dir / "profiling_records.json"))
    monkeypatch.setattr(bcommon, "N_RUNS", N_RUNS)
    monkeypatch.setattr(pcommon, "RESULTS_DIR", str(records_dir))
    return records_dir


@pytest.fixture
def ref_init(monkeypatch):
    """The port's MLPs start from the reference MLP's initial weights for
    the same hidden sizes and seed."""
    def init(self, f_in, f_out):
        ref = RMLP(hidden=tuple(self.hidden), lr=self.lr,
                   optimiser=self.optimiser, epochs=0, seed=self.seed)
        ref.fit(np.zeros((2, f_in), np.float32),
                np.zeros((2, f_out), np.float32))
        return {k: torch.as_tensor(np.array(v))
                for k, v in ref.params_.items()}

    monkeypatch.setattr(MLPRegressor, "_init", init)


def short_mlp(monkeypatch, ref, port, kw_name=None):
    """The benches' centralised MLPs trained for 20 epochs on both sides
    (the reference module's class name, the port's keywords or class)."""
    monkeypatch.setattr(ref, "MLPRegressor", lambda *a, **kw: RMLP(
        *a, **{**kw, "epochs": 20}))
    if kw_name is None:
        monkeypatch.setattr(port, "MLPRegressor", lambda *a, **kw:
                            MLPRegressor(*a, **{**kw, "epochs": 20}))
    else:
        monkeypatch.setattr(port, kw_name, {**getattr(port, kw_name),
                                            "epochs": 20})


def ref_bench(name):
    return importlib.import_module(f"benchmarks.{name}")


def port_bench(name):
    return importlib.import_module(f"repro_torch.bench.{name}")


def assert_rows_match(got, want, timed, rtol=None):
    """The port's rows in the reference's order, every field outside
    ``timed`` equal, or within ``rtol`` for floats when it is given."""
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert g.get("plain") is True, g
        extra = set(g) - set(w) - PORT_FIELDS - set(timed)
        assert not extra, (w["name"], extra)
        for k, v in w.items():
            if k in timed:
                continue
            if rtol is None or not isinstance(v, float):
                assert g[k] == v, (w["name"], k, g[k], v)
            else:
                np.testing.assert_allclose(g[k], v, rtol=rtol,
                                           err_msg=f"{w['name']}.{k}")


def test_profiling_dataset_reads_its_own_cache(results, monkeypatch):
    from repro_torch.bench import common
    from repro_torch.core import dataset as ds
    monkeypatch.setattr(ds, "generate", lambda **kw: pytest.fail(
        "the cache was not read"))
    records, data = common.profiling_dataset(device="cpu")
    assert len({r.label for r in records if "@" not in r.label}) == N_RUNS
    from benchmarks.common import profiling_dataset as ref_dataset
    _, rdata = ref_dataset()
    assert np.array_equal(data.x, rdata.x)
    assert np.array_equal(data.y, rdata.y)


def test_profiling_dataset_profiles_into_its_own_file(tmp_path,
                                                      monkeypatch):
    """Without a cache of enough runs it profiles on the device asked for
    and writes ``profiling_records_torch.json``, never the reference's
    ``profiling_records.json``."""
    from repro_torch.bench import common
    from repro_torch.core import dataset as ds
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    (tmp_path / "profiling_records.json").write_text("not the port's")
    seen = {}
    real = ds.generate

    def small(**kw):
        seen.update(kw)
        return real(**dict(kw, n_runs=2, max_steps=1))

    monkeypatch.setattr(ds, "generate", small)
    records, _ = common.profiling_dataset(n_runs=2, device="cpu")
    assert seen["device"] == "cpu" and seen["max_steps"] == 6
    assert (tmp_path / "profiling_records_torch.json").exists()
    assert (tmp_path / "profiling_records.json").read_text() \
        == "not the port's"
    assert len(records) == 10


def test_fig2a_rows_match_the_reference(results, ref_init, monkeypatch):
    ref, port = ref_bench("fig2a_mlp"), port_bench("fig2a_mlp")
    presets = {k: ref.SIZE_PRESETS[k] for k in ("xs", "xl")}
    monkeypatch.setattr(ref, "SIZE_PRESETS", presets)
    monkeypatch.setattr(port, "SIZE_PRESETS", presets)
    want = ref.main(epochs=3)
    got = port.main(epochs=3, device="cpu")
    assert_rows_match(got, want, port.TIMED, rtol=MLP_RTOL)


def test_fig2b_rows_equal_the_reference(results, monkeypatch):
    ref, port = ref_bench("fig2b_gbt"), port_bench("fig2b_gbt")
    for mod in (ref, port):
        monkeypatch.setattr(mod, "DEPTHS", (2, 12))
        monkeypatch.setattr(mod, "SUBSAMPLES", (0.5, 0.8))
    want = ref.main()
    got = port.main(device="cpu")
    assert_rows_match(got, want, port.TIMED)


def test_fig3_row_matches_the_reference(results, ref_init, monkeypatch):
    ref, port = ref_bench("fig3_predictions"), port_bench(
        "fig3_predictions")
    short_mlp(monkeypatch, ref, port, "MLP_KW")
    want = ref.main()
    got = port.main(device="cpu")
    # the GBT's fields exactly, the MLP's within MLP_RTOL
    mlp = ("nrmse_mlp_xl", "gbt_vs_mlp_ratio")
    assert_rows_match(got, [{k: v for k, v in r.items() if k not in mlp}
                            for r in want], port.TIMED + mlp)
    assert_rows_match(got, want, port.TIMED, rtol=MLP_RTOL)


def test_offload_rows_equal_the_reference(results):
    ref, port = ref_bench("bench_offload"), port_bench("offload")
    want = ref.main()
    got = port.main(device="cpu")
    assert_rows_match(got, want, port.TIMED)


def test_fl_rows_match_the_reference(results, ref_init, monkeypatch):
    ref, port = ref_bench("bench_fl"), port_bench("fl")
    short_mlp(monkeypatch, ref, port)
    # 2 rounds of 15 on both sides
    from repro.core import fl as rfl
    run = rfl.run_fedavg
    monkeypatch.setattr(ref, "run_fedavg", lambda clients, cfg, **kw: run(
        clients, rfl.FedAvgConfig(**{**cfg.__dict__, "rounds": 2}), **kw))
    want = ref.main()
    _, data = port.profiling_dataset(device="cpu")
    got = port.fl_rows(data, "cpu", CPU, rounds=2)
    for w in want[1:]:
        w["rounds"] = 2              # the reference's row names 15
    assert_rows_match(got, want, port.TIMED, rtol=MLP_RTOL)


def test_serving_rows_match_the_reference(results, monkeypatch):
    ref, port = ref_bench("bench_serving"), port_bench("serving")
    assert ref.ARCHS == port.ARCHS
    got = port.main(device="cpu")
    assert [r["name"] for r in got] == [f"serve_{a}" for a in ref.ARCHS]
    assert all(r["tokens_out"] == 4 * 16 for r in got)
    monkeypatch.setattr(ref, "ARCHS", ref.ARCHS[:1])
    want = ref.main()
    assert_rows_match(got[:1], want, port.TIMED)


PROFILING_BENCHES = ("fig2a_mlp", "fig2b_gbt", "fig3_predictions",
                     "offload", "fl", "serving")


@pytest.mark.parametrize("name", PROFILING_BENCHES)
def test_bench_without_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_bench(name).main()


def test_the_benches_wrote_nothing_into_the_repo(untouched_repo):
    """Runs last in this module: the tree and the repo root's bench
    outputs and caches are as they were before the tests above."""
    assert repo_state() == untouched_repo
