"""Timing and output shared by the port's benchmarks and ``chip_smoke.py``:
CUDA-event timing, the H100 bound of a piece of work, the card's name and
power limit, and the ``name,us_per_call,derived`` CSV + JSON rows of
``benchmarks/common.py``."""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import torch

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "results")

# The H100 SXM's published rates (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12            # device memory
F32_OPS_PER_S = 67e12                # f32 outside the tensor cores
F64_OPS_PER_S = 34e12                # f64 outside the tensor cores
BF16_OPS_PER_S = 989e12              # dense bf16 on the tensor cores


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S
          ) -> tuple[float, str]:
    """The least time (ms) the card could take for the work, and what sets
    it: the larger of ``nbytes`` over the memory rate and ``ops`` over the
    peak rate of the work's type."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def timed_ms(fn, reps: int, groups: int = 5, graph: bool = False) -> float:
    """Median over ``groups`` of the mean CUDA-event time (ms) of ``reps``
    back-to-back calls of ``fn``, after 3 warm-up calls.

    ``graph=True`` captures the ``reps`` calls in one CUDA graph and times
    its replays (after one more), so the host's launch path (Python,
    ``ctypes``) drops out and the time is the device's; ``fn`` must then
    make no host sync."""
    side = torch.cuda.Stream()       # warm-up off the stream captured
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    out = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def host_ms(fn, reps: int = 3) -> float:
    """Median host wall time (ms) of ``reps`` calls of ``fn`` after one
    warm-up: for work on the CPU only."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def emit(rows: list[dict], name: str) -> None:
    """Print ``name,us_per_call,derived`` CSV rows and write them as JSON
    to ``results/bench_torch_<name>.json``."""
    os.makedirs(RESULTS_DIR, exist_ok=True)
    path = os.path.join(RESULTS_DIR, f"bench_torch_{name}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        derived = ";".join(f"{k}={v}" for k, v in r.items()
                           if k not in ("name", "us_per_call"))
        print(f"{r.get('name', name)},{r.get('us_per_call')},{derived}")
