"""Bench orchestrator of the port, the counterpart of
``benchmarks/run.py``: the reference's ten benches in its order, each the
``repro_torch.bench`` module of its name, under its ``# ===`` header and
``# ---`` footer.

Prints each bench's ``name,us_per_call,derived`` CSV.  A bench that raises
is counted, its traceback printed, and the others run; the run then exits
non-zero.  The device is resolved once, before the first bench: without a
card and without ``--device cpu`` it raises at once.

Run:  PYTHONPATH=src python -m repro_torch.bench.run [FILTER]
      [--device cpu]       # FILTER: run only the benches whose header
                           # contains it
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback

from repro_torch._device import resolve_device

#: (header, module of repro_torch.bench), in the reference's order
BENCHES = (
    ("fig2a_mlp (paper Fig. 2a)", "fig2a_mlp"),
    ("fig2b_gbt (paper Fig. 2b)", "fig2b_gbt"),
    ("fig3_predictions (paper Fig. 3)", "fig3_predictions"),
    ("offload (paper §II-C)", "offload"),
    ("decisions (vectorized core)", "decisions"),
    ("scheduler (paper §II-D)", "scheduler"),
    ("fl (paper §II-B)", "fl"),
    ("kernels", "kernels"),
    ("serving", "serving"),
    ("roofline (deliverable g)", "roofline"),
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("only", nargs="?", default="",
                    help="run only the benches whose header contains this")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda), which "
                    "raises without one; 'cpu' runs only the CPU rows")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = 0
    for name, module in BENCHES:
        if args.only and args.only not in name:
            continue
        print(f"# === {name} ===", flush=True)
        t0 = time.time()
        try:
            importlib.import_module(f"repro_torch.bench.{module}").main(
                device=dev)
        except Exception:                      # noqa: BLE001
            failures += 1
            traceback.print_exc()
        print(f"# --- {name} done in {time.time()-t0:.0f}s", flush=True)
    if failures:
        raise SystemExit(f"{failures} benchmark(s) failed")


if __name__ == "__main__":
    main()
