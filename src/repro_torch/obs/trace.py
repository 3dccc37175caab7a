"""The port's tracing seam: the no-op tracer every ``obs=`` defaults to, and
the flight-recorder post-mortem the event loops call before re-raising.

The port does not carry the reference's collecting tracer (``repro.obs``,
ROADMAP §1 item 11).  Its ``obs=`` seams are duck-typed instead: a tracer
needs ``enabled``, ``span(...)``, ``instant(...)`` and ``task_spans(...)``
(the fleet engine's column batches also ``span_arrays(...)`` and
``instant_arrays(...)``, and :func:`postmortem_dump` ``last(n)``), which a
``repro.obs``
tracer passed in by a test provides.  With :data:`NULL_TRACER` every hook
is a no-op, so traced and untraced runs compute the same numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional

__all__ = ["NullTracer", "NULL_TRACER", "postmortem_dump"]


class NullTracer:
    """The default ``obs``: tracing off, every hook a no-op."""

    enabled = False

    def span(self, *args, **kwargs) -> None:
        pass

    def instant(self, *args, **kwargs) -> None:
        pass

    def task_spans(self, *args, **kwargs) -> None:
        pass

    def span_arrays(self, *args, **kwargs) -> None:
        pass

    def instant_arrays(self, *args, **kwargs) -> None:
        pass

    def last(self, n: int = 64) -> list:
        return []


NULL_TRACER = NullTracer()


def postmortem_dump(tracer, *, clock_s: float, error: str = "",
                    path: str = "results/postmortem.json",
                    n: int = 64) -> Optional[dict]:
    """Flight-recorder post-mortem: the last ``n`` traced events
    (``tracer.last(n)``, each a dataclass) plus the crashing clock reading,
    written to ``path`` and summarised on stderr.  A no-op returning
    ``None`` unless ``tracer.enabled``; otherwise returns the dump.

    Unlike the reference's, a failure inside the dump itself is not
    swallowed: it propagates, chained to the exception being handled."""
    if not getattr(tracer, "enabled", False):
        return None
    events = [{"kind": type(ev).__name__, **dataclasses.asdict(ev)}
              for ev in tracer.last(n)]
    dump = {"clock_s": float(clock_s), "error": str(error),
            "n_events": len(events), "events": events}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dump, f, indent=1, default=float)
    print(f"[repro_torch.obs] post-mortem: {len(events)} flight-recorder "
          f"events at t={clock_s:.6g}s -> {path}"
          + (f" ({error})" if error else ""), file=sys.stderr)
    return dump
