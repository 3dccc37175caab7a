"""Roofline table of the port's dry-run: one row per (architecture ×
input shape) with its three terms on the H100, the counterpart of
``benchmarks/bench_roofline.py`` (the source of the EXPERIMENTS writer's
§Roofline).

It reads the records ``python -m repro_torch.launch.dryrun --all --out
results/dryrun_torch.json`` writes.  A row's ``us_per_call`` is the bound
(the largest term), ``mem_gib_per_dev`` the record's ``bytes_per_device``
and ``fits_hbm80`` its fit in the H100's 80 GB; the dry-run runs on meta
tensors, so there is no TPU-adjusted size.  A record that did not run is
a row with its ``status``.

Run:  PYTHONPATH=src python -m repro_torch.bench.roofline [PATH]
      [--device cpu]

Rows go to ``results/bench_torch_roofline.json``.
"""
from __future__ import annotations

import json
import os

from repro_torch.bench import common
from repro_torch.bench.common import emit, parser, paths

#: the dry-run's records under the results directory, by default
DRYRUN_NAME = "dryrun_torch.json"
TIMED = ()


def roofline_rows(recs: list[dict]) -> list[dict]:
    """The reference's row of each dry-run record, read from the port's
    fields."""
    rows = []
    for r in recs:
        name = f"roofline_{r['arch']}_{r['shape']}"
        if r["status"] != "ok":
            rows.append({"name": name, "status": r["status"]})
            continue
        roof = r["roofline"]
        bound = max(roof["compute_s"], roof["memory_s"],
                    roof["collective_s"])
        rows.append({
            "name": name,
            "us_per_call": bound * 1e6,
            "dominant": roof["dominant"],
            "compute_s": roof["compute_s"],
            "memory_s": roof["memory_s"],
            "collective_s": roof["collective_s"],
            "useful_ratio": roof["useful_ratio"],
            "mem_gib_per_dev": r["bytes_per_device"] / 2**30,
            "fits_hbm80": r["fits_hbm80"],
        })
    return rows


def main(path: str = "", device=None) -> list[dict]:
    """Rows of the dry-run at ``path`` (default
    ``results/dryrun_torch.json``); ``[]`` when it is missing."""
    paths(device)                    # the card, unless asked for the CPU
    path = path or os.path.join(common.RESULTS_DIR, DRYRUN_NAME)
    if not os.path.exists(path):
        print(f"roofline,,skipped=no {path}; run "
              "repro_torch.launch.dryrun first")
        return []
    with open(path) as f:
        rows = roofline_rows(json.load(f))
    emit(rows, "roofline")
    return rows


if __name__ == "__main__":
    ap = parser(__doc__, smoke=False)
    ap.add_argument("path", nargs="?", default="",
                    help=f"dry-run records (default results/{DRYRUN_NAME})")
    args = ap.parse_args()
    main(args.path, device=args.device)
