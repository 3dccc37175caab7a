"""Collate the port's bench rows into one table, the counterpart of
``benchmarks/report.py``: for each of the five subsystems the reference
keeps a baseline of (``BENCH_3`` … ``BENCH_7``), the headline comparison
of the port's rows (the row with the largest ``speedup_vs_*`` value) and
its throughput figure, with the card the row ran on (``cpu`` for a CPU
row).

The rows are the port modules' (``results/bench_torch_<name>.json``):
``decisions_backend`` (``python -m repro_torch.bench.decisions --backend
all``), ``stream``, ``oracle``, ``fleet`` and ``contention``.  The
reference's ``--readme`` and ``--check`` keep README's table equal to the
committed ``BENCH_*.json``, the reference's CPU baselines; the port
commits no rows and leaves that table alone.

Run:  PYTHONPATH=src python -m repro_torch.bench.report [--results DIR]
      [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.bench import common

#: the port's rows of each reference baseline
FILES = {3: "decisions_backend", 4: "stream", 5: "oracle", 6: "fleet",
         7: "contention"}
#: one line of context per baseline: what it measures, and what the
#: speedup is measured against (the reference's)
SUBSYSTEMS = {
    3: ("decision backends", "decide_all jax/Pallas vs numpy"),
    4: ("streaming re-planning", "incremental vs from-scratch per arrival"),
    5: ("oracle serving", "lowered predictors vs host ensembles"),
    6: ("fleet engine", "time-slabbed arrays vs host event loop"),
    7: ("edge contention", "incremental pool waits vs full recompute"),
}

_THROUGHPUT_KEYS = ("events_per_sec", "decisions_per_s",
                    "predictions_per_s")


def _headline(rows: list[dict]) -> tuple[dict, str, float] | None:
    """(row, speedup key, value) for the largest speedup in the file."""
    best = None
    for row in rows:
        for key, val in row.items():
            if key.startswith("speedup_vs_") and isinstance(
                    val, (int, float)):
                if best is None or val > best[2]:
                    best = (row, key, float(val))
    return best


def _throughput(row: dict) -> str:
    for key in _THROUGHPUT_KEYS:
        if key in row:
            unit = key.replace("_per_sec", "/s").replace("_per_s", "/s")
            return f"{row[key]:,.0f} {unit}"
    if "us_per_arrival" in row:
        return f"{row['us_per_arrival']:.1f} us/arrival"
    if "us_per_call" in row:
        return f"{row['us_per_call']:.1f} us/call"
    return "-"


def collect(root: str = "") -> list[dict]:
    """The headline of each baseline's rows found under ``root`` (default
    ``REPRO_RESULTS`` or ``results``)."""
    root = root or common.RESULTS_DIR
    out = []
    for num, name in sorted(FILES.items()):
        path = os.path.join(root, f"bench_torch_{name}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            head = _headline(json.load(f))
        if head is None:
            continue
        row, _, val = head
        subsystem, what = SUBSYSTEMS[num]
        out.append({
            "bench": f"bench_torch_{name}",
            "subsystem": subsystem,
            "comparison": what,
            "config": row.get("name", "-"),
            "speedup": val,
            "throughput": _throughput(row),
            "card": row.get("card", "cpu"),
        })
    return out


def table(entries: list[dict]) -> str:
    lines = [
        "| rows | subsystem | comparison | headline config "
        "| speedup | throughput | card |",
        "|---|---|---|---|---|---|---|",
    ]
    for e in entries:
        lines.append(
            f"| `{e['bench']}` | {e['subsystem']} | {e['comparison']} "
            f"| `{e['config']}` | {e['speedup']:.1f}x "
            f"| {e['throughput']} | {e['card']} |")
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--results", default="",
                    help="directory of the bench_torch_*.json rows "
                    "(default REPRO_RESULTS or results)")
    ap.add_argument("--out", default="",
                    help="also write the markdown table to this file")
    args = ap.parse_args(argv)
    entries = collect(args.results)
    tbl = table(entries)
    print(tbl)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(tbl + "\n")
        print(f"\n[report] wrote {args.out}")
    return entries


if __name__ == "__main__":
    main()
