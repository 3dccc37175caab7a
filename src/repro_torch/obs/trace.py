"""Zero-perturbation tracing: per-task lifecycle spans, instant events and
a bounded flight recorder — the port of ``repro.obs.trace``.

A :class:`Tracer` collects two kinds of structured events:

``SpanEvent``
    a named interval on a *track* — in the simulators a track is one node
    (or pool) and spans are the task lifecycle (``sojourn ⊃ queue_wait ·
    service · transfer``); in the serving engines a track is the engine
    and spans are prefill/decode phases.
``InstantEvent``
    a point event — replan, split re-pick, pool saturation, Page–Hinkley
    drift trigger, oracle refit, registry publish.

Timestamps are whatever clock the caller lives on: virtual seconds inside
:mod:`repro_torch.sim` (the engines pass event-loop / slab times; the
tracer reads no clock), wall seconds in :mod:`repro_torch.serve` (the
engines pass their already-measured ``perf_counter`` readings).  The
tracer only observes values the engines already compute: it draws no
random number and touches no float path, and with :data:`NULL_TRACER`
(every ``obs=`` seam's default) every hook is a no-op, so traced and
untraced runs compute the same numbers.

Ingestion paths mirror :class:`repro_torch.sim.telemetry.Telemetry`:

  * :meth:`Tracer.span` / :meth:`Tracer.instant` /
    :meth:`Tracer.task_spans` — the event loop's per-event path;
  * :meth:`Tracer.span_arrays` / :meth:`Tracer.instant_arrays` — the
    fleet engine's slab path: one call holds parallel columns for a whole
    run, deferred, and materialised into events on first read.  Each
    column (a list, a numpy array or a tensor on any device) is brought
    to the host once, as a whole, at that read: never element by element.
    Columns are held by reference until then; the fleet engine passes
    fresh arrays (fancy-indexed copies) that nothing writes afterwards.
    A column may also be a :class:`Deferred`: its rows are built at that
    read, so a column the run would otherwise make row by row in Python
    (the ``node@j`` track labels) costs the run nothing.

The last ``ring`` events (spans and instants interleaved in ingestion
order) are kept in a bounded flight-recorder deque: :meth:`Tracer.last`
replays the recent history for a post-mortem.

Export: :meth:`Tracer.export_chrome` writes Chrome trace-event JSON
(Perfetto / ``chrome://tracing``) through :mod:`repro_torch.obs.chrome`.

Deviations from the reference:

* :meth:`Tracer.task_spans` ends the ``service`` span at
  ``max(started, finished - transfer)``.  The reference ends it at
  ``finished - transfer``, which rounding can put an ulp before
  ``started`` when the service time is 0 (or below an ulp of the clock);
  its ``span`` then raises and the traced run dies (ROADMAP §3).  Every
  task the reference accepts keeps its exact spans.
* :func:`postmortem_dump` lets a failure of the dump itself propagate,
  chained to the exception being handled; the reference swallows it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
from collections import deque
from typing import Optional, Sequence

__all__ = ["SpanEvent", "InstantEvent", "NullTracer", "Tracer",
           "NULL_TRACER", "Deferred", "postmortem_dump"]


class Deferred:
    """A column of ``n`` rows that ``build()`` makes when the tracer
    first reads it (its export), not when the run hands it over.  It
    iterates as the built rows, so a tracer that copies its columns at
    once (the reference's) reads it as a list."""

    __slots__ = ("n", "build")

    def __init__(self, n: int, build):
        self.n, self.build = int(n), build

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        return iter(self.build())


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One named interval ``[t0, t1]`` on ``(track, tid)``.

    ``track`` maps to a Chrome trace *process* (one per node / pool /
    engine), ``tid`` to a thread within it (one per task, so each task's
    lifecycle renders as its own row and B/E nesting is exact).
    """
    track: str
    tid: int
    name: str
    t0: float
    t1: float
    args: Optional[dict] = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class InstantEvent:
    """One point event at ``ts`` on ``(track, tid)``."""
    track: str
    tid: int
    name: str
    ts: float
    args: Optional[dict] = None


class NullTracer:
    """The no-op tracer, the default of every ``obs=`` seam.

    Every hook returns at once; hot paths also test :attr:`enabled` so
    that with tracing off not even an event's argument tuple is built.
    """

    __slots__ = ()
    enabled = False

    def span(self, track: str, name: str, t0: float, t1: float, *,
             tid: int = 0, args: Optional[dict] = None) -> None:
        pass

    def instant(self, track: str, name: str, ts: float, *,
                tid: int = 0, args: Optional[dict] = None) -> None:
        pass

    def task_spans(self, track: str, tid: int, name: str,
                   arrived_s: float, started_s: float, finished_s: float,
                   *, transfer_s: float = 0.0,
                   args: Optional[dict] = None) -> None:
        pass

    def span_arrays(self, tracks, tids, names, arrived_s, started_s,
                    finished_s, *, transfer_s=None,
                    args_cols=None) -> None:
        pass

    def instant_arrays(self, track, name, ts, *, tid: int = 0,
                       args_cols=None) -> None:
        pass

    def last(self, n: int = 64) -> list:
        return []

    def export_chrome(self, path: str) -> None:
        raise ValueError(
            "cannot export a trace from the no-op tracer — pass "
            "obs=Tracer() to the run you want traced")


#: the singleton every ``obs=None`` seam resolves to
NULL_TRACER = NullTracer()


def _host_list(col) -> Optional[list]:
    """A column as a Python list, brought to the host in one piece: a
    tensor or a numpy array through one ``tolist()`` (a tensor on the card
    is one copy), a list element by element only where an element is
    itself a numpy or torch scalar (``.item()``, as the reference reads
    it)."""
    if col is None:
        return None
    if isinstance(col, Deferred):
        return _host_list(col.build())
    tolist = getattr(col, "tolist", None)
    if tolist is not None:
        return tolist()
    return [v.item() if hasattr(v, "item") else v for v in col]


class Tracer(NullTracer):
    """Collecting tracer (see the module docstring for the event model).

    ``ring`` bounds the flight-recorder deque.  The tracer is append-only
    and clock-agnostic: callers stamp every event themselves, so one class
    serves virtual-time simulation and wall-time serving alike.
    """

    __slots__ = ("spans", "instants", "_pending", "_ring")
    enabled = True

    def __init__(self, ring: int = 4096):
        self.spans: list[SpanEvent] = []
        self.instants: list[InstantEvent] = []
        self._pending: list[tuple] = []      # deferred column batches
        self._ring: deque = deque(maxlen=int(ring))

    # -- ingestion: per-event path ----------------------------------------
    def span(self, track: str, name: str, t0: float, t1: float, *,
             tid: int = 0, args: Optional[dict] = None) -> None:
        """Record one complete interval (callers know both endpoints)."""
        if t1 < t0:
            raise ValueError(f"span {name!r} ends before it starts "
                             f"({t1} < {t0})")
        if self._pending:
            self._materialise()
        ev = SpanEvent(str(track), int(tid), str(name), float(t0),
                       float(t1), args)
        self.spans.append(ev)
        self._ring.append(ev)

    def instant(self, track: str, name: str, ts: float, *,
                tid: int = 0, args: Optional[dict] = None) -> None:
        if self._pending:
            self._materialise()
        ev = InstantEvent(str(track), int(tid), str(name), float(ts),
                          args)
        self.instants.append(ev)
        self._ring.append(ev)

    def task_spans(self, track: str, tid: int, name: str,
                   arrived_s: float, started_s: float, finished_s: float,
                   *, transfer_s: float = 0.0,
                   args: Optional[dict] = None) -> None:
        """One task's lifecycle as nested spans on its own ``(track, tid)``
        row::

            sojourn   [arrived, finished]
              queue_wait [arrived, started]          (omitted if 0)
              service    [started, service_end]
              transfer   [service_end, finished]     (omitted if 0)

        with ``service_end = max(started, finished - transfer)`` (see the
        module docstring).  The ``sojourn`` span carries ``args``."""
        arrived_s = float(arrived_s)
        started_s = float(started_s)
        finished_s = float(finished_s)
        transfer_s = float(transfer_s)
        self.span(track, "sojourn", arrived_s, finished_s, tid=tid,
                  args={"task": name, **(args or {})})
        if started_s > arrived_s:
            self.span(track, "queue_wait", arrived_s, started_s, tid=tid)
        service_end = max(started_s, finished_s - transfer_s)
        self.span(track, "service", started_s, service_end, tid=tid)
        if transfer_s > 0.0:
            self.span(track, "transfer", service_end, finished_s,
                      tid=tid)

    # -- ingestion: the fleet engine's slab path --------------------------
    def span_arrays(self, tracks: Sequence[str], tids, names,
                    arrived_s, started_s, finished_s, *,
                    transfer_s=None, args_cols=None) -> None:
        """Batched :meth:`task_spans`: parallel columns (all length n) for
        one slab of completed tasks, deferred — equivalent to n
        ``task_spans`` calls in column order, for one tuple append now.

        ``args_cols`` maps an arg key to a parallel column stamped onto
        each row's ``sojourn`` span (``deadline_s``, ``split``, ...);
        ``None`` entries mean "no such arg for this row"."""
        n = len(names)
        for label, col in (("tracks", tracks), ("tids", tids),
                           ("arrived_s", arrived_s),
                           ("started_s", started_s),
                           ("finished_s", finished_s)):
            if len(col) != n:
                raise ValueError(f"column {label} has {len(col)} rows, "
                                 f"expected {n}")
        if transfer_s is not None and len(transfer_s) != n:
            raise ValueError(f"column transfer_s has {len(transfer_s)} "
                             f"rows, expected {n}")
        for key, col in (args_cols or {}).items():
            if len(col) != n:
                raise ValueError(f"args column {key!r} has {len(col)} "
                                 f"rows, expected {n}")
        self._pending.append(("spans", tracks, tids, names, arrived_s,
                              started_s, finished_s, transfer_s,
                              args_cols))

    def instant_arrays(self, track: str, name: str, ts, *, tid: int = 0,
                       args_cols: Optional[dict] = None) -> None:
        """Batched :meth:`instant`: one deferred append for a run of
        same-named instants (``ts`` the timestamp column, ``args_cols``
        arg key -> parallel column), equivalent to ``len(ts)`` instant
        calls in column order."""
        n = len(ts)
        for key, col in (args_cols or {}).items():
            if len(col) != n:
                raise ValueError(f"args column {key!r} has {len(col)} "
                                 f"rows, expected {n}")
        self._pending.append(("instants", str(track), str(name), ts,
                              int(tid), args_cols))

    def _materialise(self) -> None:
        batches, self._pending = self._pending, []
        for batch in batches:
            if batch[0] == "spans":
                (_, tracks, tids, names, arrived, started, finished,
                 transfer, args_cols) = batch
                tracks, tids, names, arrived, started, finished, \
                    transfer = (_host_list(c) for c in (
                        tracks, tids, names, arrived, started, finished,
                        transfer))
                cols = {key: _host_list(col)
                        for key, col in (args_cols or {}).items()}
                for k in range(len(names)):
                    args = None
                    if args_cols is not None:
                        args = {key: col[k] for key, col in cols.items()
                                if col[k] is not None} or None
                    self.task_spans(
                        tracks[k], int(tids[k]), names[k],
                        float(arrived[k]), float(started[k]),
                        float(finished[k]),
                        transfer_s=0.0 if transfer is None
                        else float(transfer[k]),
                        args=args)
            else:
                _, track, name, ts, tid, args_cols = batch
                ts = _host_list(ts)
                cols = None if args_cols is None else {
                    key: _host_list(col) for key, col in args_cols.items()}
                for k in range(len(ts)):
                    self.instant(
                        track, name, float(ts[k]), tid=tid,
                        args=None if cols is None else
                        {key: col[k] for key, col in cols.items()})

    # -- reads ------------------------------------------------------------
    def __len__(self) -> int:
        n = len(self.spans) + len(self.instants)
        return n + sum(len(b[3]) for b in self._pending)

    def all_spans(self) -> list[SpanEvent]:
        if self._pending:
            self._materialise()
        return self.spans

    def all_instants(self) -> list[InstantEvent]:
        if self._pending:
            self._materialise()
        return self.instants

    def last(self, n: int = 64) -> list:
        """The flight recorder: the most recent ``min(n, ring)`` events in
        ingestion order."""
        if self._pending:
            self._materialise()
        if n <= 0:
            return []
        buf = list(self._ring)
        return buf[-int(n):]

    # -- export -----------------------------------------------------------
    def export_chrome(self, path: Optional[str]) -> dict:
        """Write the trace as Chrome trace-event JSON (to ``path`` when
        given) and return the trace object: one Chrome *process* per
        track, one *thread* per tid, matched B/E pairs nested."""
        from repro_torch.obs.chrome import export_chrome
        return export_chrome(self, path)


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
