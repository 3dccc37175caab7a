"""Timing and output shared by the port's benchmarks and ``chip_smoke.py``:
CUDA-event and host timing, the H100 bound of a piece of work, the card's
name and power limit, the ``name,us_per_call,derived`` CSV + JSON rows of
``benchmarks/common.py``, its cached profiling dataset, and what every
bench module of the package shares: the runs one invocation makes (the CPU,
the card's plain path, the kernels) and the kernels' launch counts."""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

RESULTS_DIR = os.environ.get("REPRO_RESULTS", "results")
#: the port's own profiling cache: the reference's records
#: (``profiling_records.json``) were measured on another machine
RECORDS_NAME = "profiling_records_torch.json"

# The H100 SXM's published rates (NVIDIA's data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12            # device memory
F32_OPS_PER_S = 67e12                # f32 outside the tensor cores
F64_OPS_PER_S = 34e12                # f64 outside the tensor cores
BF16_OPS_PER_S = 989e12              # dense bf16 on the tensor cores
TF32_OPS_PER_S = 495e12              # dense TF32 on the tensor cores


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


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (read
    once a process)."""
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


def clock() -> float:
    """Host clock once the card (where it is in use) has finished its
    queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


def times_us(fn, reps: int) -> tuple[float, float]:
    """(median, best) host wall time per call of ``fn`` in µs over ``reps``
    calls after one warm-up, each ending at :func:`clock`."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = clock()
        fn()
        ts.append(clock() - t0)
    return float(np.median(ts) * 1e6), float(np.min(ts) * 1e6)


def profiling_dataset(n_runs: int = 0, force: bool = False,
                      device: DeviceLike = None):
    """(records, TabularDataset): measured Table-I grid runs (each projected
    onto the other edge specs), profiled on ``device`` (None = the card)
    and cached in ``results/profiling_records_torch.json``.  ``n_runs``
    defaults to ``REPRO_PROFILE_RUNS`` (150); a cache with at least that
    many measured runs is read instead of profiling again."""
    from repro_torch.core import dataset as ds
    from repro_torch.core.features import records_to_dataset
    n_runs = n_runs or int(os.environ.get("REPRO_PROFILE_RUNS", "150"))
    path = os.path.join(RESULTS_DIR, RECORDS_NAME)
    os.makedirs(RESULTS_DIR, exist_ok=True)
    if os.path.exists(path) and not force:
        records = ds.load_records(path)
        if len({r.label for r in records if "@" not in r.label}) >= n_runs:
            return records, records_to_dataset(records)
    t0 = time.time()
    records, data = ds.generate(n_runs=n_runs, max_steps=6, verbose=True,
                                device=device)
    ds.save_records(records, path)
    print(f"[bench] generated {len(records)} profiling records "
          f"in {time.time()-t0:.0f}s -> {path}")
    return records, data


# -- what the bench modules share ------------------------------------------
def paths(device: DeviceLike = None) -> list[tuple[str, torch.device]]:
    """``[(path, torch device)]`` of one invocation: only ``("cpu", cpu)``
    with ``device="cpu"``; otherwise three, which need the card
    (``device=None`` raises without one): ``"cpu"``, the port's plain path
    on the CPU (the reference's host / numpy rows); ``"card"``, the plain
    path on the card (its jitted rows); ``"kernel"``, the hand-written
    kernels on the card (its Pallas rows)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [("cpu", dev)]
    return [("cpu", torch.device("cpu")), ("card", dev), ("kernel", dev)]


def parser(doc: str, smoke: bool = True) -> argparse.ArgumentParser:
    """A bench's argument parser: ``--device``, and ``--smoke`` where the
    reference's script has it."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda), which "
                    "raises without one; 'cpu' runs only the CPU rows")
    if smoke:
        ap.add_argument("--smoke", action="store_true",
                        help="small sizes / few reps")
    return ap


def require(ok, msg: str) -> None:
    """A bench's gate: the reference's ``assert``, kept under ``-O``."""
    if not ok:
        raise AssertionError(msg)


class GateBroken(AssertionError):
    """Gates that failed once their bench's rows were made: ``gates`` says
    each with its numbers, ``rows`` are the rows (written before this is
    raised, so that the numbers of a broken gate are kept)."""

    def __init__(self, gates: list[str], rows: list[dict]):
        super().__init__("; ".join(gates))
        self.gates = gates
        self.rows = rows


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launches so far (the kernels' counters)."""
    from repro_torch.kernels.decide_split import kernel as ds_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fleet_scan import kernel as fs_kernel
    from repro_torch.kernels.gbt_hist import kernel as gh_kernel
    from repro_torch.kernels.slstm_scan import kernel as sl_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel
    from repro_torch.kernels.tree_predict import kernel as tp_kernel
    return dict(decide_split=ds_kernel.decide_split_kernel.launches,
                tree_predict=tp_kernel.tree_predict_kernel.launches,
                gbt_hist=gh_kernel.level_histogram_kernel.launches,
                fleet_scan=fs_kernel.place_singletons_kernel.launches,
                flash_attention=fa_kernel.flash_attention_kernel.launches,
                ssm_scan=ss_kernel.ssd_scan_kernel.launches,
                slstm_scan=sl_kernel.slstm_scan_kernel.launches)


@contextlib.contextmanager
def counting():
    """Yields a dict that holds, after the block, each kernel's launches
    made inside it (kernels not launched left out)."""
    before = launch_counts()
    got: dict[str, int] = {}
    try:
        yield got
    finally:
        got.update({k: n - before[k] for k, n in launch_counts().items()
                    if n > before[k]})


def tag(row: dict, path: str, launches: dict | None = None,
        kernels: tuple = ()) -> dict:
    """Flag ``row`` by its path: CPU rows ``plain: true``; card rows the
    card's name and power limit (``card``) and the kernels launched during
    the row (``launches``); a kernel row fails unless each of ``kernels``
    was launched."""
    if path == "cpu":
        row["plain"] = True
        return row
    row["card"] = card()
    row["launches"] = dict(launches or {})
    if path == "kernel":
        missing = [k for k in kernels if row["launches"].get(k, 0) <= 0]
        require(kernels and not missing, f"{row['name']}: kernel(s) "
                f"{missing or '(none named)'} not launched during the row "
                f"(launches {row['launches']})")
    return row
