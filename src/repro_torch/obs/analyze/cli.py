"""``python -m repro_torch.obs.analyze`` — trace analytics from the shell,
with the sub-commands, flags, output and exit codes of
``python -m repro.obs.analyze``.

Three subcommands, mirroring the library entry points:

``attribution TRACE [--json OUT] [--misses]``
    Phase attribution + deadline-miss report for one exported
    ``trace.json``.

``diff TRACE_A TRACE_B [--align task|arrival] [--top-k N] [--json OUT]``
    Differential profile of run B against baseline A.

``regress BASE [FRESH] [--tol T] [--tol-metric NAME=T ...]
[--selftest] [--json OUT]``
    Regression gate: exit 0 clean, **1 on regression** (the CI
    contract), 2 on usage/IO error.  ``--selftest`` needs no FRESH:
    the baseline must pass against itself and a perturbed copy must be
    flagged.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

__all__ = ["main"]


def _dump(obj: dict, path: Optional[str]) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(obj, f, indent=1, default=float)
        print(f"wrote {path}")


def _cmd_attribution(ns: argparse.Namespace) -> int:
    from repro_torch.obs.analyze.attribution import attribute
    run = attribute(ns.trace)
    print(run.table_str())
    ma = run.miss_attribution()
    if ns.misses and ma["misses"]:
        print("  -- per-miss detail --")
        for m in ma["misses"]:
            ev = ",".join(m["evidence"]) or "-"
            print(f"  {m['task']:>14} on {m['track']:>10}: "
                  f"{m['cause']} (+{m['excess_s']:.4g}s past deadline, "
                  f"evidence: {ev})")
    _dump({"summary": run.summary(), "phase_shares": run.phase_shares(),
           "by_track": run.by_track(), "miss_attribution": ma},
          ns.json)
    return 0


def _cmd_diff(ns: argparse.Namespace) -> int:
    from repro_torch.obs.analyze.diff import diff
    rep = diff(ns.trace_a, ns.trace_b, align=ns.align, top_k=ns.top_k)
    print(rep.table_str())
    _dump(rep.to_dict(), ns.json)
    return 0


def _parse_tols(specs: Sequence[str]) -> dict:
    out = {}
    for spec in specs:
        name, _, val = spec.partition("=")
        if not name or not val:
            raise ValueError(f"--tol-metric wants NAME=TOL, got "
                             f"{spec!r}")
        out[name] = float(val)
    return out


def _cmd_regress(ns: argparse.Namespace) -> int:
    from repro_torch.obs.analyze.regress import (compare_rows,
                                                 load_rows, selftest)
    tols = _parse_tols(ns.tol_metric)
    base = load_rows(ns.base)
    if ns.selftest:
        ok, text = selftest(base, default_tol=ns.tol, tol=tols)
        print(text)
        return 0 if ok else 1
    if not ns.fresh:
        raise ValueError("regress needs FRESH (or --selftest)")
    rep = compare_rows(base, load_rows(ns.fresh),
                       default_tol=ns.tol, tol=tols)
    print(rep.table_str())
    _dump(rep.to_dict(), ns.json)
    return 0 if rep.ok else 1


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.analyze",
        description="trace analytics: attribution, diff, regression "
                    "gate")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("attribution",
                        help="phase + deadline-miss attribution")
    pa.add_argument("trace", help="exported trace.json")
    pa.add_argument("--json", default=None, help="write report JSON")
    pa.add_argument("--misses", action="store_true",
                    help="print per-miss detail lines")
    pa.set_defaults(fn=_cmd_attribution)

    pd = sub.add_parser("diff", help="differential profile B vs A")
    pd.add_argument("trace_a")
    pd.add_argument("trace_b")
    pd.add_argument("--align", choices=("task", "arrival"),
                    default="task")
    pd.add_argument("--top-k", type=int, default=10)
    pd.add_argument("--json", default=None)
    pd.set_defaults(fn=_cmd_diff)

    pr = sub.add_parser("regress",
                        help="regression gate (exit 1 on regression)")
    pr.add_argument("base", help="committed baseline rows JSON")
    pr.add_argument("fresh", nargs="?", default=None,
                    help="fresh rows JSON (omit with --selftest)")
    pr.add_argument("--tol", type=float, default=0.2,
                    help="default relative tolerance band")
    pr.add_argument("--tol-metric", action="append", default=[],
                    metavar="NAME=TOL",
                    help="per-metric override (repeatable; "
                         "'row.metric=T' is most specific)")
    pr.add_argument("--selftest", action="store_true",
                    help="gate the baseline against itself + a "
                         "perturbed copy")
    pr.add_argument("--json", default=None)
    pr.set_defaults(fn=_cmd_regress)

    ns = p.parse_args(argv)
    try:
        return ns.fn(ns)
    except (OSError, ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
