"""The port's versions of the reference's ``examples/``, one module each.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]``,
keeps the reference script's flags and prints its lines in its format.
``--device`` defaults to the card (``resolve_device(None)``), which raises
without one: nothing falls back to the CPU unless asked.  Each step is a
function that returns its values, so that tests can hold them against the
reference's.
"""
from __future__ import annotations

import argparse
import time

import torch

__all__ = ["EXAMPLES", "parser", "clock", "require"]

#: the ten modules, in the order of the reference's README
EXAMPLES = ("offload_simulation", "contention_tails", "quickstart",
            "oracle_serving", "streaming_offload", "trace_analytics",
            "serve_batched", "train_tiny_lm", "fl_profiling",
            "pod_scale_scheduling")


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the port's ``--device`` flag."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (cuda), which "
                    "raises without one")
    return ap


def clock(dev) -> float:
    """Host clock after ``dev`` has finished its queued work."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def require(ok, msg: str) -> None:
    """The reference example's ``assert``, kept under ``python -O``."""
    if not ok:
        raise AssertionError(msg)
