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


def assert_loads_no_jax_and_no_reference(module):
    """Importing ``module`` alone, in a fresh interpreter, loads neither
    JAX nor the reference package."""
    code = (f"import {module}, sys\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
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
                                    "repro_torch.kernels.int8_matmul.ref",
                                    "repro_torch.kernels.int8_matmul.ops",
                                    "repro_torch.kernels.int8_matmul.kernel"])
def test_bench_and_int8_modules_load_no_jax_and_no_reference(module):
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
