"""The port's examples of the decision, simulation and observability paths
against the reference's scripts on the CPU: ``offload_simulation``,
``contention_tails``, ``streaming_offload``, ``trace_analytics``,
``oracle_serving`` and ``pod_scale_scheduling``.

Each reference script runs under ``runpy`` and each port module with
``--device cpu``; their standard outputs must agree line for line, once
the host-timing numbers (``HOST_TIMING``) are masked on both sides.

- ``oracle_serving``'s reference cannot be imported here (``repro.oracle``
  needs ``jax.experimental.enable_x64``): it comes in under a bare
  ``repro.oracle`` package, as ``tests/test_torch_oracle.py``'s ``ref``
  fixture does, with its ``backend="jax"`` sweep on ``backend="numpy"``;
  both sides fit a 20-tree GBT instead of 120 to keep the test short (the
  reference's per-tree numpy predict dominates its run).
- ``pod_scale_scheduling`` reads a small list of dry-run records the test
  builds by hand, and both packages schedule on the reference's TPU
  fleet.
- Without ``--device`` each example raises here (no card) instead of
  running on the CPU.
"""
import importlib
import json
import pathlib
import re
import runpy
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.examples import EXAMPLES
from repro_torch.hw import DeviceSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]

# host timing, masked on both sides before the lines are compared
HOST_TIMING = (
    r"in [0-9.]+ ms",                       # offload_simulation's sweeps
    r"[0-9,]+ decisions/s",
    r"scheduled in +[0-9.]+ ms",            # pod_scale_scheduling
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: torch's CPU thread pool beside JAX's only contends
    (the port's GBT fits ran 2.5x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the port's flags that name a file the reference finds beside its script
PORT_FLAGS = {"trace_analytics": ("--baseline", str(ROOT / "BENCH_7.json"))}


def masked(text: str) -> list[str]:
    lines = text.splitlines()
    for pat in HOST_TIMING:
        lines = [re.sub(pat, "<host>", ln) for ln in lines]
    return lines


def port_module(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def run_reference(name, capsys, run=None) -> str:
    capsys.readouterr()
    if run is None:
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    else:
        run()
    return capsys.readouterr().out


def run_port(name, capsys, argv=("--device", "cpu")) -> str:
    capsys.readouterr()
    port_module(name).main(list(argv))
    return capsys.readouterr().out


@pytest.mark.parametrize("name", ["offload_simulation", "contention_tails",
                                  "trace_analytics"])
def test_port_prints_the_reference_lines(name, capsys):
    want = masked(run_reference(name, capsys))
    got = masked(run_port(name, capsys,
                          ("--device", "cpu", *PORT_FLAGS.get(name, ()))))
    assert len(want) >= 6
    assert got == want


def test_streaming_offload_prints_the_reference_lines(capsys, tmp_path,
                                                      monkeypatch):
    want = masked(run_reference("streaming_offload", capsys))
    monkeypatch.chdir(tmp_path)
    got = masked(run_port("streaming_offload", capsys))
    assert got == want
    # the trace under the working directory, as the line says
    trace = json.loads((tmp_path / "results" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_trace_analytics_names_a_missing_baseline(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="no baseline at BENCH_7.json"):
        port_module("trace_analytics").main(["--device", "cpu"])


def test_offload_simulation_steps_return_their_values():
    mod = port_module("offload_simulation")
    _, layers = mod.workload()
    rows = mod.policy_table(layers, "cpu")
    assert list(rows) == list(mod.LINKS)
    for cells in rows.values():
        assert len(cells) == len(mod.POLICIES)
        optimal = cells[mod.POLICIES.index("optimal")][0]
        assert all(t >= optimal * (1 - 1e-12) for t, _ in cells)
    shares, n, dt = mod.dense_sweep(layers, "cpu")
    assert n == 4096 and dt > 0 and set(shares) == set(mod.SWEEP_DEVICES)


@pytest.fixture
def ref_oracle(monkeypatch):
    """The reference's ``online`` module under a bare ``repro.oracle``
    package carrying ``OnlineOracle``, and ``decide_all``'s ``jax``
    backend sent to ``numpy`` (the jax one needs ``enable_x64``)."""
    stub = types.ModuleType("repro.oracle")
    stub.__path__ = [str(ROOT / "src" / "repro" / "oracle")]
    monkeypatch.setitem(sys.modules, "repro.oracle", stub)
    for sub in ("online", "registry"):
        monkeypatch.setitem(sys.modules, f"repro.oracle.{sub}", None)
        del sys.modules[f"repro.oracle.{sub}"]
    stub.OnlineOracle = importlib.import_module(
        "repro.oracle.online").OnlineOracle
    from repro.core import decisions as rdec
    decide_all = rdec.decide_all

    def numpy_for_jax(*a, backend="numpy", **kw):
        return decide_all(*a, backend="numpy" if backend == "jax"
                          else backend, **kw)

    monkeypatch.setattr(rdec, "decide_all", numpy_for_jax)


def test_oracle_serving_prints_the_reference_lines(ref_oracle, capsys,
                                                   monkeypatch):
    trees = (256, 20, 8)            # n_layers, n_trees, max_depth
    ref = runpy.run_path(str(ROOT / "examples" / "oracle_serving.py"))
    monkeypatch.setattr(ref["fit_profiler"], "__defaults__", trees)
    want = masked(run_reference("oracle_serving", capsys, ref["main"]))
    mod = port_module("oracle_serving")
    monkeypatch.setattr(mod.fit_profiler, "__defaults__", trees)
    got = masked(run_port("oracle_serving", capsys))
    # the reference's accelerator sweep is XLA's, the port's the kernel's;
    # the exact sweep it is held to is numpy's there, torch's f64 here
    want = [ln.replace("backend='jax'", "backend='kernel'")
              .replace("match numpy", "match torch") for ln in want]
    assert any("drift detected" in ln for ln in got)
    assert got == want


# the reference's fleet (examples/pod_scale_scheduling.py:72-84), as
# port DeviceSpecs: both packages schedule on it
REF_FLEET = (
    DeviceSpec("v5e-pod", "tpu", "tpu-v5e", 197e12 * 256, 98e12 * 256,
               16e9 * 256, 819e9 * 256, 50e9, 1.7, tdp_watts=250 * 256),
    DeviceSpec("v5e-half", "tpu", "tpu-v5e", 197e12 * 128, 98e12 * 128,
               16e9 * 128, 819e9 * 128, 50e9, 1.7, tdp_watts=250 * 128),
    DeviceSpec("v4-pod", "tpu", "tpu-v4", 275e12 * 128, 137e12 * 128,
               32e9 * 128, 1200e9 * 128, 45e9, 1.05, tdp_watts=200 * 128),
    DeviceSpec("edge-octo", "gpu", "cuda", 312e12 * 8, 19.5e12 * 8,
               40e9 * 8, 1555e9 * 8, 25e9, 1.41, tdp_watts=400 * 8))


def dryrun_records(n=14, seed=3) -> list[dict]:
    """Dry-run records by hand: the ten architectures over the input
    shapes, roofline terms drawn from ``seed``, one skipped record."""
    from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES
    rng = np.random.default_rng(seed)
    shapes = list(INPUT_SHAPES)
    recs = []
    for i in range(n):
        terms = 10.0 ** rng.uniform(-4, 1, 3)
        recs.append({"status": "ok", "arch": ARCH_NAMES[i % len(ARCH_NAMES)],
                     "shape": shapes[(i * 3) % len(shapes)],
                     "roofline": dict(zip(("compute_s", "memory_s",
                                           "collective_s"),
                                          map(float, terms)))})
    recs.append({"status": "skipped", "arch": "whisper-tiny",
                 "shape": shapes[-1]})
    return recs


def test_pod_scale_scheduling_prints_the_reference_lines(capsys, tmp_path,
                                                         monkeypatch):
    recs = dryrun_records()
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "dryrun_single_pod.json").write_text(
        json.dumps(recs))
    want = masked(run_reference("pod_scale_scheduling", capsys))
    mod = port_module("pod_scale_scheduling")
    capsys.readouterr()
    mod.report(recs, REF_FLEET, "cpu")
    got = masked(capsys.readouterr().out)
    assert "over 14 workloads" in got[0]
    assert got == want


def test_pod_scale_scheduling_reads_the_port_dryrun_path(capsys, tmp_path,
                                                         monkeypatch):
    mod = port_module("pod_scale_scheduling")
    monkeypatch.chdir(tmp_path)
    out = run_port("pod_scale_scheduling", capsys)
    assert out == f"run the dry-run first: {mod.DRYRUN} missing\n"
    path = tmp_path / "records.json"
    path.write_text(json.dumps(dryrun_records(5)))
    out = run_port("pod_scale_scheduling", capsys,
                   ("--device", "cpu", "--dryrun", str(path))).splitlines()
    assert "over 5 workloads" in out[0]
    # the port's fleet in cards: H100 × 256, × 128, A100 × 8, with TDPs
    assert [s.name for s in mod.FLEET] == ["h100-256", "h100-128",
                                           "a100-8"]
    assert [s.tdp_watts for s in mod.FLEET] == [700 * 256, 700 * 128,
                                                mod.FLEET[2].tdp_watts]
    assert mod.FLEET[2].tdp_watts == 8 * mod.get_device(
        "edge-server-a100").tdp_watts


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_module(name).main([])
