"""Profiling-dataset generation (paper §III-A: ">3,000 runs").

The port of ``repro.core.dataset``: runs the Table-I grid through the
profiler on the torch ``device`` (None = cuda) and assembles the tabular
regression dataset.  ``max_steps`` truncates each run (per-step time is
measured, total time extrapolated).

Heterogeneity augmentation: each measured record is re-projected onto the
other edge-device specs analytically (scaled by relative roofline), as the
reference does; projected rows carry ``@<device>`` in their label.  The
records' JSON is the reference's, so either package reads the other's.
"""
from __future__ import annotations

import dataclasses
import json
import time

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.features import records_to_dataset
from repro_torch.core.profiler import ProfileRecord, profile_workload
from repro_torch.core.workloads import sample_grid
from repro_torch.hw import EDGE_DEVICES, get_device


def generate(n_runs: int = 120, *, max_steps: int = 8, seed: int = 0,
             measure: bool = True, augment_hardware: bool = True,
             verbose: bool = False, device: DeviceLike = None):
    """Returns (records, TabularDataset)."""
    dev = resolve_device(device)
    grid = sample_grid(n_runs, seed=seed)
    base_spec = get_device("xps15-i5")
    records: list[ProfileRecord] = []
    t0 = time.time()
    for i, wc in enumerate(grid):
        rec = profile_workload(wc, spec=base_spec, measure=measure,
                               max_steps=max_steps, seed=seed + i,
                               device=dev)
        records.append(rec)
        if verbose and (i + 1) % 20 == 0:
            print(f"[dataset] {i+1}/{len(grid)} runs "
                  f"({time.time()-t0:.0f}s)")
    if augment_hardware:
        records += project_hardware(records)
    return records, records_to_dataset(records)


def project_hardware(records: list[ProfileRecord]) -> list[ProfileRecord]:
    """Analytic re-projection of measured runs onto other device specs."""
    base = get_device("xps15-i5")
    out = []
    for rec in records:
        for name, dev in EDGE_DEVICES.items():
            if name == base.name:
                continue
            # scale times by the inverse compute-throughput ratio, bounded
            # by the memory-bandwidth ratio (roofline projection)
            comp_ratio = base.peak_flops_f32 / dev.peak_flops_f32
            mem_ratio = base.hbm_bw / dev.hbm_bw
            scale = max(comp_ratio, mem_ratio)
            out.append(dataclasses.replace(
                rec,
                label=f"{rec.label}@{name}",
                total_time_s=rec.total_time_s * scale,
                step_time_s=rec.step_time_s * scale,
                hardware=dev.as_features(),
            ))
    return out


def save_records(records: list[ProfileRecord], path: str) -> None:
    with open(path, "w") as f:
        json.dump([dataclasses.asdict(r) for r in records], f)


def load_records(path: str) -> list[ProfileRecord]:
    with open(path) as f:
        return [ProfileRecord(**d) for d in json.load(f)]
