"""The PyTorch port stands alone: importing it loads neither JAX nor the
reference package, no file of it imports either, and its entry points run
on CUDA unless the caller asks for the CPU."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib')) or k == 'repro'\n"
        "             or k.startswith('repro.'))\n"
        "print(bad)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def assert_loads_no_jax_and_no_reference(module, also=()):
    """Importing ``module`` alone, in a fresh interpreter, loads neither
    JAX nor the reference package (nor any top-level package of
    ``also``)."""
    banned = ("jax", "jaxlib", "repro", *also)
    code = (f"import {module}, sys\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{banned!r}))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("module", ["repro_torch.models",
                                    "repro_torch.serve",
                                    "repro_torch.launch.serve"])
def test_serving_subpackages_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.bench.kernels",
                                    "repro_torch.bench.mlp_spread",
                                    "repro_torch.bench.common",
                                    "repro_torch.bench.decisions",
                                    "repro_torch.bench.oracle",
                                    "repro_torch.bench.stream",
                                    "repro_torch.bench.fleet",
                                    "repro_torch.bench.contention",
                                    "repro_torch.bench.fig2a_mlp",
                                    "repro_torch.bench.fig2b_gbt",
                                    "repro_torch.bench.fig3_predictions",
                                    "repro_torch.bench.offload",
                                    "repro_torch.bench.fl",
                                    "repro_torch.bench.scheduler",
                                    "repro_torch.bench.serving",
                                    "repro_torch.bench.scan_bwd",
                                    "repro_torch.bench.scan_train",
                                    "repro_torch.kernels.int8_matmul.ref",
                                    "repro_torch.kernels.int8_matmul.ops",
                                    "repro_torch.kernels.int8_matmul.kernel"])
def test_bench_and_int8_modules_load_no_jax_and_no_reference(module):
    """The bench modules also load nothing of the reference's
    ``benchmarks/`` scripts."""
    assert_loads_no_jax_and_no_reference(module, also=("benchmarks",))


@pytest.mark.parametrize("module", ["repro_torch.optim",
                                    "repro_torch.data",
                                    "repro_torch.core.profiler",
                                    "repro_torch.core.workloads",
                                    "repro_torch.core.features",
                                    "repro_torch.core.dataset",
                                    "repro_torch.core.predictors.linear",
                                    "repro_torch.core.predictors.mlp",
                                    "repro_torch.oracle"])
def test_profiling_modules_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.oracle",
                                    "repro_torch.oracle.online",
                                    "repro_torch.oracle.registry",
                                    "repro_torch.sim",
                                    "repro_torch.obs",
                                    "repro_torch.core.scheduler",
                                    "repro_torch.core.pomdp"])
def test_oracle_and_sim_modules_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.obs.trace",
                                    "repro_torch.obs.chrome",
                                    "repro_torch.obs.metrics",
                                    "repro_torch.obs.analyze",
                                    "repro_torch.obs.analyze.sketch",
                                    "repro_torch.obs.analyze.tables",
                                    "repro_torch.obs.analyze.attribution",
                                    "repro_torch.obs.analyze.diff",
                                    "repro_torch.obs.analyze.regress",
                                    "repro_torch.obs.analyze.cli"])
def test_obs_modules_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.sim.queueing",
                                    "repro_torch.sim.pareto",
                                    "repro_torch.sim.fleet",
                                    "repro_torch.kernels.fleet_scan.ref",
                                    "repro_torch.kernels.fleet_scan.ops",
                                    "repro_torch.kernels.fleet_scan.kernel"])
def test_queueing_pareto_and_fleet_modules_load_no_jax_and_no_reference(
        module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.models.mla",
                                    "repro_torch.models.transformer",
                                    "repro_torch.serve.continuous"])
def test_moe_mla_and_continuous_modules_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("module", ["repro_torch.models.xlstm",
                                    "repro_torch.models.xlstm_model",
                                    "repro_torch.models.encdec",
                                    "repro_torch.kernels.slstm_scan.ref",
                                    "repro_torch.kernels.slstm_scan.ops",
                                    "repro_torch.kernels.slstm_scan.kernel"])
def test_xlstm_and_encdec_modules_load_no_jax_and_no_reference(module):
    assert_loads_no_jax_and_no_reference(module)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_file_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {name}"


def test_device_none_means_cuda_and_raises_without_a_card(monkeypatch):
    from repro_torch.core import decisions as dec
    from repro_torch.core import offload as off
    from repro_torch.core.predictors.gbt import GBTRegressor
    from repro_torch.hw import get_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        dec.make_envs(pi5, a100, link_bw=[1e6])
    envs = dec.make_envs(pi5, a100, link_bw=[1e6], device="cpu")
    layers = [off.LayerCost("l0", flops=1e9, act_bytes=1e4)]
    for backend in ("kernel", "torch"):
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            dec.decide_all(layers, envs, backend=backend)
    x = np.random.default_rng(0).normal(size=(32, 3))
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        GBTRegressor(n_trees=1).fit(x, x[:, 0])
    # explicitly asked for, the CPU runs
    assert len(dec.decide_all(layers, envs, device="cpu")) == 1


def test_oracle_and_stream_entry_points_need_a_card_by_default(monkeypatch):
    from repro_torch import sim
    from repro_torch.core import costs as co
    from repro_torch.core import decisions as dec
    from repro_torch.core import scheduler as sch
    from repro_torch.core.predictors.gbt import GBTRegressor
    from repro_torch.hw import get_device
    from repro_torch.oracle import OnlineOracle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pi5, a100 = get_device("pi5-arm"), get_device("edge-server-a100")
    x = np.random.default_rng(0).normal(size=(32, 7)).astype(np.float32)
    gbt = GBTRegressor(n_trees=2, max_depth=2).fit(x, x[:, 0], device="cpu")
    tasks, nodes = [sch.Task("t", flops=1e9)], [sch.Node(a100)]
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        OnlineOracle(gbt, pi5, a100)
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        sim.simulate_stream(tasks, [0.0], nodes)
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        sim.StreamScheduler(nodes)
    for cost in (co.PredictorCost(gbt, pi5, a100), co.AnalyticCost()):
        with pytest.raises(RuntimeError, match="device=None means cuda"):
            sch.etc_matrix(tasks, nodes, cost=cost)
    env = sim.DriftingEnv(pi5, a100, sim.FixedLink(1e6))
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        env.snapshot()
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        sim.simulate_stream(tasks, [0.0], nodes, engine="fleet")
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        sim.ParetoStreamScheduler()
    with pytest.raises(RuntimeError, match="device=None means cuda"):
        dec.stack_envs([])
    # explicitly asked for, the CPU runs
    oracle = OnlineOracle(gbt, pi5, a100, torch_device="cpu")
    tel = sim.simulate_stream(tasks, [0.0], nodes, oracle=oracle,
                              device="cpu")
    assert len(tel) == 1 and oracle.observations == 1
